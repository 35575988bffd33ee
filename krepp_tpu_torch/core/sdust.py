"""SDUST symmetric low-complexity masker (Morgulis et al. 2006).

Faithful reimplementation of the algorithm as vendored by the reference
(ref: src/sdust.h:90-185; the masker is enabled with --sdust-t/--sdust-w and
default-off per src/krepp.hpp:44-45). Operates on base codes (0..3, 4=N);
returns [(start, finish)] masked intervals, finish exclusive, in base
coordinates.

State: sliding window w of triplet codes (capacity W-2), per-triplet counts
and running scores for the whole window (cw/rw) and for the maximal suffix v
in which no triplet occurs more than 2T/10 times (cv/rv, length L). A
"perfect" interval has normalized score r/l > T/10 and dominates every
perfect interval it contains; P holds the current window's perfect
intervals sorted by descending start then ascending finish.

The port's own copy of krepp_tpu/core/sdust.py: the port imports
nothing of the JAX package, so it carries the host code it needs.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _save_masked(res: List[List[int]], P: List[List[int]], start: int) -> None:
    """Flush the lowest-start perfect interval once it leaves the window."""
    if not P or P[-1][0] >= start:
        return
    s0, f0 = P[-1][0], P[-1][1]
    saved = False
    if res:
        rs, rf = res[-1]
        if s0 <= rf:  # overlapping/adjacent with the previous result
            saved = True
            res[-1][1] = max(rf, f0)
    if not saved:
        res.append([s0, f0])
    i = len(P) - 1
    while i >= 0 and P[i][0] < start:
        i -= 1
    del P[i + 1:]


def _find_perfect(P: List[List[int]], w: List[int], T: int, start: int,
                  L: int, rv: int, cv: List[int]) -> None:
    c = cv.copy()
    r = rv
    max_r = max_l = 0
    for i in range(len(w) - L - 1, -1, -1):
        t = w[i]
        r += c[t]
        c[t] += 1
        new_r, new_l = r, len(w) - i - 1
        if new_r * 10 > T * new_l:
            j = 0
            while j < len(P) and P[j][0] >= i + start:
                p = P[j]
                if max_r == 0 or p[2] * max_l > max_r * p[3]:
                    max_r, max_l = p[2], p[3]
                j += 1
            if max_r == 0 or new_r * max_l >= max_r * new_l:
                max_r, max_l = new_r, new_l
                P.insert(j, [i + start, len(w) + 2 + start, new_r, new_l])


def sdust(codes: np.ndarray, T: int = 20, W: int = 64) -> List[Tuple[int, int]]:
    """Mask intervals of a base-code sequence (0..3 bases, >=4 breaks)."""
    res: List[List[int]] = []
    P: List[List[int]] = []
    w: List[int] = []
    cv = [0] * 64
    cw = [0] * 64
    rv = rw = 0
    L = 0
    l = 0
    t = 0
    n = len(codes)
    for i in range(n + 1):
        b = int(codes[i]) if i < n else 4
        if b < 4:
            l += 1
            t = ((t << 2) | b) & 63
            if l >= 3:
                start = max(l - W, 0) + (i + 1 - l)
                _save_masked(res, P, start)
                # shift window
                if len(w) >= W - 2:
                    s = w.pop(0)
                    cw[s] -= 1
                    rw -= cw[s]
                    if L > len(w):
                        L -= 1
                        cv[s] -= 1
                        rv -= cv[s]
                w.append(t)
                L += 1
                rw += cw[t]
                cw[t] += 1
                rv += cv[t]
                cv[t] += 1
                if cv[t] * 10 > T * 2:
                    while True:
                        s = w[len(w) - L]
                        cv[s] -= 1
                        rv -= cv[s]
                        L -= 1
                        if s == t:
                            break
                if rw * 10 > L * T:
                    _find_perfect(P, w, T, start, L, rv, cv)
        else:
            # N (or end) flushes pending perfect intervals; note the window
            # and counters deliberately persist across the break, matching
            # the vendored implementation (ref: src/sdust.h:176-181)
            start = max(l - W + 1, 0) + (i + 1 - l)
            while P:
                _save_masked(res, P, start)
                start += 1
            l = t = 0
    return [(s, f) for s, f in res]
