"""``non_k2_device_ms.train``: device time a training step of every
operation that is not one of K2's kernels (the sampler, the regularisers,
the clip, Adam, copies), from the profiler's trace, in milliseconds."""


def read(run):
    tr, r = run.trace, run.readings
    if tr is None or not r.get("steps") or tr.total_device_s() <= 0:
        return None
    k2 = sum(tr.kernel_s(name) for name in r.get("k2_kernels", {}))
    return 1e3 * (tr.total_device_s() - k2) / r["steps"]
