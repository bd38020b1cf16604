"""``mfu.train``: K2 b's operations in the training steps of the traced
run's untraced rest of the window (from the profiler's stop), counted from the configuration's widths
(``counts.k2_flops``), over that rest's seconds at the bf16 peak, in
percent. The rest, not the traced part: the profiler's own host work slows
the steps it covers wherever the host paces them."""

from portbench import counts


def read(run):
    samples = run.final.get("samples", 0) - run.readings.get("samples", 0)
    seconds = run.rest_s
    if samples <= 0 or seconds <= 0:
        return None
    return 100.0 * counts.k2_flops(run.config["specs"], samples) / counts.PEAK_FLOPS["bfloat16"] / seconds
