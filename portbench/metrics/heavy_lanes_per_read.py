"""Probe positions sent to the hybrid probe's heavy tail per read (the
program's counters `heavy_lanes` over `reads`); None where the program
keeps no such counter."""

from ..program import HOOK, ratio, reading

SPANS = HOOK


def read(run):
    r = reading(run)
    if r is None or "heavy_lanes" not in r.counts:
        return None
    return ratio(run, "heavy_lanes", "reads")
