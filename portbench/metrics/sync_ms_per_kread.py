"""Host time blocked in the host syncs inside a step (the program's span
`sync`: core.host_turn.host_int and host_wait), ms per 1,000 reads of the
window."""

from ..program import HOOK, per_kread

SPANS = HOOK


def read(run):
    return per_kread(run, ("sync",))
