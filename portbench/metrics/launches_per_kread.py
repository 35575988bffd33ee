"""Kernel launches (the runtime's LaunchKernel calls) per 1,000 reads of
the traced pass."""


def read(run):
    tr = run.trace
    if tr is None or not tr.reads:
        return None
    return tr.launches / (tr.reads / 1e3)
