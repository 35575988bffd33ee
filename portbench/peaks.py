"""The card's published peaks and the work of the kernels whose roofline
share the benchmark reports, counted from the batch's sizes."""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, 80 GB HBM3 (at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12


def tiles_bytes(lengths, facts: dict) -> int:
    """Bytes probe_hist_tiles's work needs for one batch step of reads of
    the given lengths: the bucket rows of the reads' real k-mer positions
    on both strands (whether gathered before the kernel or inside it;
    padding is not work), the residuals and light flags, each read once,
    the mask words once, and the [N, S, X] histogram and [N] minimum
    written once (N = 2B strands)."""
    N = 2 * len(lengths)
    pos = 2 * int(np.maximum(np.asarray(lengths, np.int64) - facts["k"] + 1,
                             0).sum())
    C0, W, S, X = facts["C0"], facts["W"], facts["S"], facts["th"] + 1
    width = 1 + 2 * C0 if facts["hflavor"] == "se" else 1 + C0 * (1 + W)
    masks = facts["nse"] * W * 4 if facts["hflavor"] == "se" else 0
    return pos * (4 * width + 4 + 1) + masks + N * S * X * 4 + N * 4
