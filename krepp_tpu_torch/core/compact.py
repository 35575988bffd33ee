"""Mask-lane compaction with static capacities (port of krepp_tpu/core/compact.py).

Both functions return the same indices and overflow flags as the JAX
versions, so capacity tiers escalate on the same batches. Sentinel slots
hold N (out of bounds): gathers through them are clamped by callers, and
scatters through them go to one extra slot that is sliced off.
"""

from __future__ import annotations

import torch


def compact_mask_indices(mask_flat: torch.Tensor, K: int):
    """Indices of the first K set lanes of mask_flat, in ascending order.

    Returns (idx [min(K, N)] int32, n_set int32 scalar tensor). One cumsum
    and one scatter; no host sync."""
    N = mask_flat.shape[0]
    dev = mask_flat.device
    K = min(K, N)
    pos = torch.cumsum(mask_flat.to(torch.int32), 0, dtype=torch.int32) - 1
    tgt = torch.where(mask_flat & (pos < K), pos, K).to(torch.int64)
    out = torch.full((K + 1,), N, dtype=torch.int32, device=dev)
    out.scatter_(0, tgt, torch.arange(N, dtype=torch.int32, device=dev))
    n_set = mask_flat.sum(dtype=torch.int32)
    return out[:K], n_set


def compact_mask_indices_strided(mask_flat: torch.Tensor, K: int,
                                 blk: int = 1024):
    """compact_mask_indices through strided blocks, with the reference's
    per-block capacity: block b holds lanes b, b+nblk, ...; each keeps its
    first Kb set lanes, and `blk_over` reports a block that held more
    (callers escalate exactly as for n_set > K).

    Returns (idx [K] int32 ascending, n_set, blk_over)."""
    N = mask_flat.shape[0]
    dev = mask_flat.device
    nblk = (N + blk - 1) // blk
    share = max(8, -(-K // nblk))
    Kb = min(blk, share + int(5 * share ** 0.5) + 8)
    if N <= 4 * blk or K >= N or nblk * Kb >= N:
        idx, n_set = compact_mask_indices(mask_flat, K)
        return idx, n_set, torch.zeros((), dtype=torch.bool, device=dev)
    Npad = nblk * blk
    mpad = torch.zeros((Npad,), dtype=torch.bool, device=dev)
    mpad[:N] = mask_flat
    gidx = (torch.arange(blk, dtype=torch.int32, device=dev)[:, None] * nblk
            + torch.arange(nblk, dtype=torch.int32, device=dev)[None, :])
    keys = torch.where(mpad.reshape(blk, nblk), gidx, N).T
    kept = torch.sort(keys, dim=1).values[:, :Kb].reshape(-1)
    counts = (keys < N).sum(dim=1, dtype=torch.int32)
    blk_over = (counts > Kb).any()
    idx = torch.sort(kept).values[:K]
    return idx, counts.sum(dtype=torch.int32), blk_over
