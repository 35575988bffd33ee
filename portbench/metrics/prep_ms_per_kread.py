"""Host time reading FASTQ and packing reads (io.fastx.QueryBatcher's
iteration, core.codec.pad_codes_batch), ms per 1,000 reads of the
window."""

SPANS = (
    ("prep", "krepp_tpu_torch.query.dist", "QueryBatcher", "iter"),
    ("prep", "krepp_tpu_torch.query.place", "QueryBatcher", "iter"),
    ("prep", "krepp_tpu_torch.query.dist", "pad_codes_batch", "call"),
    ("prep", "krepp_tpu_torch.core.codec", "pad_codes_batch", "call"),
)


def read(run):
    return run.per_kread("prep")
