"""Overflow re-runs of the engine's capacity ladder per batch over the
window (the entry's stats["escalations"])."""


def read(run):
    return run.escalations / run.batches if run.batches else None
