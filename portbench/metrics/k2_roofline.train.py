"""``k2_roofline.train``: K2's least time over the window's steps (the larger
of its operations at the bf16 peak and its input and output bytes, each
once, at the HBM bandwidth) over the profiler's device time of K2's
kernels, in percent. The kernels are found by the names the program counts
launches under (``fused_train.KERNEL_LAUNCHES``); the trace's launches of
each must equal the counter's, or nothing is read."""

import sys

from portbench import counts


def read(run):
    tr, r = run.trace, run.readings
    if tr is None or not r.get("steps") or not r.get("k2_kernels"):
        return None
    for name, launches in r["k2_kernels"].items():
        if tr.kernel_count(name) != launches:
            print(f"k2_roofline.train: {name} launched {launches} times by the counter, "
                  f"{tr.kernel_count(name)} in the trace", file=sys.stderr)
            return None
    device_s = sum(tr.kernel_s(name) for name in r["k2_kernels"])
    if device_s <= 0:
        return None
    cfg, B, P = run.config["specs"], r["scenes_per_step"], r["points_per_scene"]
    least = counts.least_seconds(counts.k2_flops(cfg, B * P), counts.k2_io_bytes(cfg, B, P), "bfloat16")
    return 100.0 * r["steps"] * least / device_s
