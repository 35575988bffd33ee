"""Host time blocked on the card (query.engine._Pending.get: a batch's
outputs waited for), ms per 1,000 reads of the window."""

SPANS = (("wait", "krepp_tpu_torch.query.engine", "_Pending.get", "call"),)


def read(run):
    return run.per_kread("wait")
