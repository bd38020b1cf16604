"""``fetch_wait_ms.train``: the median length of an epoch's ``stage1.fetch``
span (the packing of the epoch's metrics and their one copy to the host,
the epoch's one wait for the device) in the traced run's untraced rest, in
milliseconds: how far the host ran ahead of the device at the epoch's end.
Near 0, the host paces the epoch. None where the program records no
spans."""

from portbench import program_spans


def read(run):
    recs = program_spans.rest()
    return program_spans.median_ms([r for r in recs or () if r.name == "stage1.fetch"])
