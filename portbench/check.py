"""The comparison that decides `correct`: the program's report rows for a
sample of the reads, drawn from the seed, against the plain reference's.

The number compared is the widest gap over the sample: dist, |printed
distance - reference distance| of each (read, genome) row; place, the
largest |printed - reference| of the five numbers of each (read, edge)
jplace row. A row that one side has and the other lacks reads as a gap
of 1; dist's NA row of a read is an empty set of rows, and a read
missing from dist's report lacks even that. The program prints five decimals, so a
sound run reads at most 5e-6 plus the card's own rounding; each limit and
the readings it was set from are in PERF.md.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Iterable

MISSING = 1.0


def parse_dist(text: str, wanted: Iterable[str]) -> Dict[str, dict]:
    """dist TSV -> read -> {genome: distance} ({} for its NA row), for
    the wanted reads."""
    want = set(wanted)
    out: Dict[str, dict] = {}
    for line in text.split("\n")[2:]:
        name, _, rest = line.partition("\t")
        if name not in want:
            continue
        genome, _, d = rest.partition("\t")
        row = out.setdefault(name, {})
        if genome != "NA":
            row[genome] = float(d)
    return out


def parse_place(text: str, wanted: Iterable[str]) -> Dict[str, dict]:
    """jplace -> read -> {edge number: its five numbers}, for the wanted
    reads that were placed."""
    want = set(wanted)
    out = {}
    for e in json.loads(text)["placements"]:
        (name,) = e["n"]
        if name in want:
            out[name] = {row[0]: tuple(row[1:]) for row in e["p"]}
    return out


def widest_gap(got: dict, ref: dict, names: Iterable[str]) -> float:
    """The widest gap between two reports over the named reads (see the
    module's docstring)."""
    worst = 0.0
    for name in names:
        a, b = got.get(name), ref.get(name)
        if (a is None) != (b is None):
            return MISSING
        if a is None:                   # placed by neither
            continue
        if a.keys() != b.keys():
            return MISSING
        for key, x in a.items():
            y = b[key]
            for u, v in (zip(x, y) if isinstance(x, tuple) else ((x, y),)):
                gap = abs(u - v)
                if math.isnan(gap):
                    return MISSING
                worst = max(worst, gap)
    return worst


def compare(command: str, text: str, ref: dict, names) -> float:
    got = (parse_dist if command == "dist" else parse_place)(text, names)
    return widest_gap(got, ref, names)
