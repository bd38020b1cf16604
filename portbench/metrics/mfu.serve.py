"""``mfu.serve``: the least time of the window's work over the window, in
percent: the fit's operations (forward and backward to the latent,
``counts.fit_flops``) at the float32 peak, the fit running in float32, plus
K1's operations on the points it evaluated (``counts.k1_flops``) at the
bf16 peak."""

from portbench import counts


def read(run):
    r = run.readings
    if not r.get("fit_points"):
        return None
    cfg = run.config["specs"]
    least = (counts.fit_flops(cfg, r["fit_points"]) / counts.PEAK_FLOPS["float32"]
             + counts.k1_flops(cfg, r["k1_points"]) / counts.PEAK_FLOPS["bfloat16"])
    return 100.0 * least / run.window_s
