"""Host time issuing the ops of each step (the program's spans `hash`,
`probe`, `lanes`, `stage2`, `stage3` and `outputs`: query.engine's
stages, place's stage 3 and the device-to-host copies), self time, ms per
1,000 reads of the window."""

from ..program import HOOK, per_kread

SPANS = HOOK
STEP = ("hash", "probe", "lanes", "stage2", "stage3", "outputs")


def read(run):
    return per_kread(run, STEP)
