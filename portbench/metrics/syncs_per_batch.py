"""Host sync points inside the steps per batch (the program's counters
`host_syncs` over `batches`)."""

from ..program import HOOK, ratio

SPANS = HOOK


def read(run):
    return ratio(run, "host_syncs", "batches")
