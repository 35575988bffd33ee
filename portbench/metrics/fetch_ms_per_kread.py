"""Host time building a dist batch's results from its fetched outputs
(query.engine.QueryEngine.fetch_prefetched: the [B, S] host arrays and
the overflow re-runs' own host work), ms per 1,000 reads of the window."""

SPANS = (("fetch", "krepp_tpu_torch.query.engine",
          "QueryEngine.fetch_prefetched", "call"),)


def read(run):
    return run.per_kread("fetch")
