"""The program's own spans (``msd_tpu_torch.utils.spans``) over a traced
run's untraced rest: the spans opened with no profiler recording after the
last one opened while it recorded. The rest, not the traced part: the
profiler's host work slows what it covers, as ``mfu.train`` says.

``rest()`` is None where the program records no spans (a tree without
``utils/spans.py``), where no span ran under the profiler or after it, or
where the ring no longer holds the last span the profiler covered, and so
perhaps not the whole rest."""

from __future__ import annotations

import statistics


def rest():
    """The rest's span records, oldest first, or None."""
    try:
        from msd_tpu_torch.utils import spans
    except ImportError:
        return None
    recs = spans.records()
    traced = [r.id for r in recs if r.profiled]
    if not traced:
        return None
    last = max(traced)
    return [r for r in recs if r.id > last] or None


def median_ms(recs) -> float | None:
    """Median length of ``recs`` in milliseconds, or None when there are none."""
    return statistics.median(r.ns for r in recs) * 1e-6 if recs else None


def seconds_per_shape(run, names) -> float | None:
    """Seconds of the rest's spans named in ``names``, over the shapes the
    rest served (the readings at the window's end less those at the traced
    part's end)."""
    recs = rest()
    shapes = run.final.get("shapes", 0) - run.readings.get("shapes", 0)
    if not recs or shapes <= 0:
        return None
    return sum(r.ns for r in recs if r.name in names) * 1e-9 / shapes
