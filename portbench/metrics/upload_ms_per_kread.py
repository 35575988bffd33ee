"""Host time packing each batch and issuing its copies to the card (the
program's span `upload`: query.engine.QueryEngine.upload), self time, ms
per 1,000 reads of the window."""

from ..program import HOOK, per_kread

SPANS = HOOK


def read(run):
    return per_kread(run, ("upload",))
