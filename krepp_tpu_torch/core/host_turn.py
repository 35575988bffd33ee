"""Turns at the host for the sharded query engine's cell threads.

ShardedQueryEngine (parallel/mesh.py) runs the step of each mesh cell on a
host thread of its own, so that every card works while the other cells'
steps are launched. Torch releases the interpreter lock in every op, so
threads that launch ops at the same time hand the lock to one another at
every op, which costs far more than the op (chip_smoke.py phase 30 reads
it on the card's host). So a cell's step launches its ops holding its
engine's turn (`host_turn`), and gives the turn up while it waits for its
own card (`host_wait`, `host_int`: the host syncs of a step), when another
cell's thread launches its ops. The cards run at once; the host launches one
cell's ops at a time, as the interpreter lock allows anyway. Off a cell's
thread (the single-device engine, the in-turn order) both are a plain wait.

Every host sync inside a step passes here: each call is one sync point,
counted (`host_syncs`) and timed (span `sync`) by core/trace.py.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from . import trace

_local = threading.local()


@contextlib.contextmanager
def host_turn(lock: threading.Lock):
    """Hold `lock`, a sharded engine's turn, on this thread for the block;
    host_wait in the block gives it up while the card drains."""
    with lock:
        _local.turn = lock
        try:
            yield
        finally:
            _local.turn = None


def _drain(device: torch.device) -> None:
    """Wait for `device`'s current stream; on a thread that holds a turn,
    with the turn given up meanwhile."""
    if device.type != "cuda":
        return
    turn = getattr(_local, "turn", None)
    if turn is None:
        torch.cuda.current_stream(device).synchronize()
        return
    turn.release()
    try:
        torch.cuda.current_stream(device).synchronize()
    finally:
        turn.acquire()


def host_wait(device: torch.device) -> None:
    """Wait for `device`'s stream (the card drains; a host sync after this
    finds it idle): on a thread that holds a turn, with the turn given up
    meanwhile. Put before an op that syncs the host anyway (a mask index),
    it costs nothing. Nothing on the host."""
    with trace.span("sync"):
        trace.count("host_syncs")
        _drain(device)


def host_int(t: torch.Tensor) -> int:
    """int(t) of a one-element tensor, its card waited for as by
    host_wait (one sync point)."""
    with trace.span("sync"):
        trace.count("host_syncs")
        _drain(t.device)
        return int(t)
