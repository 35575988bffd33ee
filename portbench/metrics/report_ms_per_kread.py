"""Host time formatting the report (query.dist._report_batch,
query.place.flush_place_batch), ms per 1,000 reads of the window."""

SPANS = (
    ("report", "krepp_tpu_torch.query.dist", "_report_batch", "call"),
    ("report", "krepp_tpu_torch.query.place", "flush_place_batch", "call"),
)


def read(run):
    return run.per_kread("report")
