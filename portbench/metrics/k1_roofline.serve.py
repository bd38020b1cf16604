"""``k1_roofline.serve``: K1's least time for the points it evaluated in the
window (the larger of its operations, ``counts.k1_flops``, at the bf16 peak
and its 12 bytes of input and 4 of output a point at the HBM bandwidth)
over the profiler's device time of the ``fused_mlp_`` kernels, in percent.
The trace's launches must equal the program's counter
(``fused_mlp.LAUNCHES``), or nothing is read."""

import sys

from portbench import counts

KERNELS = "fused_mlp_"


def read(run):
    tr, r = run.trace, run.readings
    if tr is None or not r.get("k1_points"):
        return None
    if tr.kernel_count(KERNELS) != r["k1_launches"]:
        print(f"k1_roofline.serve: {r['k1_launches']} launches by the counter, {tr.kernel_count(KERNELS)} in "
              "the trace", file=sys.stderr)
        return None
    device_s = tr.kernel_s(KERNELS)
    if device_s <= 0:
        return None
    n = r["k1_points"]
    least = counts.least_seconds(counts.k1_flops(run.config["specs"], n), 16.0 * n, "bfloat16")
    return 100.0 * least / device_s
