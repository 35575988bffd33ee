"""The share of the traced pass's wall time in which no operation ran on
the card (the union of its kernel, copy and set intervals), %."""


def read(run):
    tr = run.trace
    if tr is None or tr.wall_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
