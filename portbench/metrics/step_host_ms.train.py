"""``step_host_ms.train``: the median host length of each epoch's first
``stage1.step`` span (the sampler through Adam) in the traced run's
untraced rest, in milliseconds. An epoch's first step starts on an empty
launch queue, its previous epoch's fetch having drained it, so no full
queue holds the host back: this is the host's own cost of a step, beside
the device's step time. None where the program records no spans."""

from portbench import program_spans


def read(run):
    recs = program_spans.rest()
    if not recs:
        return None
    epochs = {r.id for r in recs if r.name == "stage1.epoch"}
    first = {}  # the ring holds spans in the order they closed: an epoch's steps in turn
    for r in recs:
        if r.name == "stage1.step" and r.parent in epochs:
            first.setdefault(r.parent, r)
    return program_spans.median_ms(list(first.values()))
