"""Spans: the port's one recorder of where host time goes.

``with span("stage1.step"):`` records one span: its ``name``, the ``id`` of
the span around it on the same thread (``parent``, None at a thread's top),
the ``thread``, and ``start_ns``/``end_ns`` from ``time.time_ns()``. That is
the clock ``torch.profiler`` stamps its host events with (a
``record_function`` event's ``start_ns()`` in ``kineto_results`` lands on the
Unix epoch), so spans and a device trace line up. Names are
``<layer>.<phase>``: ``stage1.*`` in the Stage-1 trainer, ``fit`` and
``fit.*`` in ``reconstruct_batch``, ``mesh.*`` in the streamed
``create_mesh``.

Closed spans go into one ring of the last ``RING_SIZE`` records, shared by
every thread (a worker thread's spans have no parent). ``records()`` returns
the ring; ``summary()`` each name's count, total and self seconds (a span
less its children); ``last(name)`` the newest span of a name.

Each span notes whether a profiler was recording when it opened
(``profiled``). While one records, and only then, the span also enters
``torch.profiler.record_function(name)``, so it appears in the profiler's
trace (an operator's, ``ProfileEpochs``') and names the host's work there.
The profiler records such events on the threads it profiles: the thread
that started it, not a worker thread, whose spans stay in the ring alone.
With no profiler a span costs two clock reads, one flag read and one append,
and no dispatcher call.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch.autograd.profiler as _profiler

RING_SIZE = 2**16

_RING: collections.deque = collections.deque(maxlen=RING_SIZE)
_IDS = itertools.count()


class _Stack(threading.local):
    def __init__(self):
        self.open = []


_STACK = _Stack()


class span:
    """A context manager that records one span (see the module's
    docstring); it is its own record, and ``seconds`` is its length once
    closed."""

    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns", "profiled", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        open_ = _STACK.open
        self.parent = open_[-1].id if open_ else None
        self.id = next(_IDS)
        self.thread = threading.get_ident()
        open_.append(self)
        # the Python flag a profiler sets on start and clears on stop: the
        # cheapest check this torch has, and global, so a worker sees it too
        self.profiled = _profiler._is_profiler_enabled
        self._rf = None
        if self.profiled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _STACK.open.pop()
        _RING.append(self)
        return False

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def records() -> list:
    """The ring's closed spans, oldest first (in the order they closed); a
    copy, taken at once however many threads append."""
    return list(_RING)


def clear() -> None:
    """Empty the ring."""
    _RING.clear()


def last(name: str):
    """The newest closed span named ``name`` in the ring, or None."""
    for r in reversed(records()):  # a copy: other threads append meanwhile
        if r.name == name:
            return r
    return None


def summary(recs=None) -> dict:
    """{name: {"count", "total_s", "self_s"}} over ``recs`` (default: the
    ring). Self time is a span's length less its children's among ``recs``."""
    recs = records() if recs is None else recs
    children = collections.Counter()
    for r in recs:
        if r.parent is not None:
            children[r.parent] += r.ns
    out = {}
    for r in recs:
        s = out.setdefault(r.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        s["count"] += 1
        s["total_s"] += r.ns * 1e-9
        s["self_s"] += (r.ns - children[r.id]) * 1e-9
    return out
