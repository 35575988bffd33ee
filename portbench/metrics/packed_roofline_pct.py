"""probe_hist_packed's share of its memory roofline in the traced pass:
the bytes its work needs (peaks.tiles_bytes, which counts the same work
for either epilogue kernel on 'embed' rows, from the real read lengths of
the dispatched batches: a batch step launches the kernel once, so the
bytes are the mean over the batches times the launches) at the card's
published memory rate, over the kernel's device time, %."""

from ..peaks import HBM_BYTES_PER_S, tiles_bytes

KERNEL = "probe_hist_packed"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    t = tr.kernel_s(KERNEL)
    if t <= 0 or not tr.batches:
        return None
    per = sum(tiles_bytes(n, run.facts) for n in tr.batches) / len(
        tr.batches)
    return 100.0 * per * tr.kernel_calls(KERNEL) / HBM_BYTES_PER_S / t
