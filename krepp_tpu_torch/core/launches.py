"""Launch counts and the kept-batch hook of the hand-written kernels' wrappers.

Each wrapper (query/kernels.py, core/llh.py) carries `<name>.launches`, the
number of its kernel's launches, and the epilogue and Brent wrappers also
`<name>.keep_next` / `<name>.kept`: with keep_next set, the next launch
leaves copies of its arguments in kept and clears the flag. The sharded
query engine launches them from one host thread a card, so both go through
one lock here: `count_launch` adds exactly one however many threads launch
at once, and `take_keep` hands the hook to exactly one launch.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()


def count_launch(fn) -> None:
    """fn.launches += 1, exact under threads."""
    with _LOCK:
        fn.launches += 1


def take_keep(fn) -> bool:
    """True for the one caller that finds fn.keep_next set (and clears it)."""
    with _LOCK:
        if fn.keep_next:
            fn.keep_next = False
            return True
        return False
