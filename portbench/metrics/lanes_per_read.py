"""(read, leaf) lanes stage 2 keeps per read (the program's counters
`stage2_lanes` over `reads`)."""

from ..program import HOOK, ratio

SPANS = HOOK


def read(run):
    return ratio(run, "stage2_lanes", "reads")
