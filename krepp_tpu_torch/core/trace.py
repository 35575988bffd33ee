"""Spans and counters of the port's own layers: its one tracing registry.

Off (the default), `span(name)` returns one shared no-op context and
`count(name, n)` returns at once: one flag read each, no clock, no
allocation, no lock. On (`enable()`):

  * a span adds its self time (its duration less that of the spans opened
    inside it on the same thread, from time.perf_counter_ns) to its name's
    total, and leaves a record (name, start ns, end ns, id, parent id,
    batch, thread) in memory, up to MAX_RECORDS; each thread keeps its own
    stack, so spans nest within a thread only. A span belongs to the batch
    current on its thread when it ends (`new_batch`, `batch`), so the
    spans of one batch share its sequence number;
  * while torch.profiler records, a span also opens a
    torch.profiler.record_function of its name: the program's spans then
    annotate the device trace, on the profiler's own clock;
  * `count` adds to an integer counter; `count_device` hands over a
    one-element tensor of the step being issued, which rides to the host
    with the step's outputs (`take_device`, query/engine._Pending) and is
    added to its counter when they are waited for, so no count syncs.

`snapshot()` returns the span totals (seconds), the counters, the records
and the hand-written kernels' launch counts since the process started
(`<kernel>.launches`). Every update goes through core/launches.py's lock,
so the sharded engine's cell threads count exactly.

The spans and counters the port sets are listed in README.md
("Tracing").
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

from .launches import _LOCK

MAX_RECORDS = 1 << 20
# the hand-written kernels' wrappers (query/kernels.py), whose launch
# counts a snapshot carries
KERNELS = ("probe_hist_packed", "probe_hist_tiles", "hdist_chunk",
           "dma_gather", "brent_llh")

_on = False
_totals: Dict[str, int] = {}          # self time, ns
_counts: Dict[str, int] = {}
_records: List[tuple] = []
_dropped = 0
_device: List[Tuple[str, torch.Tensor]] = []
_ids = itertools.count()
_batches = itertools.count()
_gen = 0                              # bumped by reset: stale batches lapse
_local = threading.local()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every total, counter, record, pending device count and batch
    number (open spans still close into the new totals)."""
    global _dropped, _ids, _batches, _gen
    with _LOCK:
        _totals.clear()
        _counts.clear()
        _records.clear()
        _device.clear()
        _dropped = 0
        _ids = itertools.count()
        _batches = itertools.count()
        _gen += 1


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current_batch() -> Optional[int]:
    """The sequence number of the batch current on this thread, or None."""
    b = getattr(_local, "batch", None)
    return b[1] if b is not None and b[0] == _gen else None


class _Span:
    __slots__ = ("name", "note", "t0", "child", "id", "parent")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _stack()
        self.parent = st[-1].id if st else None
        self.id = next(_ids)
        self.child = 0
        self.note = None
        if _profiler._is_profiler_enabled:
            self.note = torch.profiler.record_function(self.name)
            self.note.__enter__()
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        t1 = time.perf_counter_ns()
        if self.note is not None:
            self.note.__exit__(*exc)
        st = _stack()
        st.pop()
        dt = t1 - self.t0
        if st:
            st[-1].child += dt
        rec = (self.name, self.t0, t1, self.id, self.parent, current_batch(),
               threading.get_ident())
        with _LOCK:
            _totals[self.name] = _totals.get(self.name, 0) + dt - self.child
            if len(_records) < MAX_RECORDS:
                _records.append(rec)
            else:
                _dropped += 1
        return False


def span(name: str):
    """A context timing the block under `name` (the shared no-op when
    off)."""
    if not _on:
        return _NOOP
    return _Span(name)


class _Batch:
    __slots__ = ("bid", "prev")

    def __init__(self, bid):
        self.bid = bid

    def __enter__(self):
        self.prev = getattr(_local, "batch", None)
        _local.batch = (_gen, self.bid)
        return self.bid

    def __exit__(self, *exc):
        _local.batch = self.prev
        return False


def batch(bid: Optional[int]):
    """A context in which `bid` (a number from new_batch, or None for
    work of no batch) is this thread's current batch."""
    if not _on:
        return _NOOP
    return _Batch(bid)


def new_batch() -> Optional[int]:
    """Number a new batch and make it this thread's current one (None when
    off)."""
    if not _on:
        return None
    bid = next(_batches)
    _local.batch = (_gen, bid)
    return bid


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name`."""
    if not _on:
        return
    with _LOCK:
        _counts[name] = _counts.get(name, 0) + int(n)


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the one-element integer-valued tensor t, of the step being
    issued, to counter `name` once the step's outputs reach the host."""
    if not _on:
        return
    with _LOCK:
        _device.append((name, t))


def take_device(device: torch.device):
    """(names, one int64 tensor of their values on `device`) of the device
    counts handed over since the last take, or None."""
    if not _on:
        return None
    with _LOCK:
        items = list(_device)
        _device.clear()
    if not items:
        return None
    return ([n for n, _ in items],
            torch.stack([t.reshape(()).to(device=device, dtype=torch.int64)
                         for _, t in items]))


def snapshot() -> dict:
    """{"spans": self seconds by name, "counts", "records", "dropped" (records
    past MAX_RECORDS), "launches": kernel launches by kernel}."""
    from ..query import kernels

    with _LOCK:
        return {"spans": {k: v * 1e-9 for k, v in _totals.items()},
                "counts": dict(_counts),
                "records": list(_records),
                "dropped": _dropped,
                "launches": {k: getattr(kernels, k).launches
                             for k in KERNELS}}
