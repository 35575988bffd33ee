"""dma_gather's plain version vs the numpy row gather (the Pallas kernel
is defined inside tools/probe_microbench.py's main() and cannot be
imported; its contract is tab[idx]), the wrapper on the host, the ported
microbenchmark at a tiny size on the CPU, and the CUDA kernel vs the plain
version on a card:
    python -m pytest --noconftest -m cuda tests/test_torch_microbench.py
"""

import io

import numpy as np
import pytest
import torch

from krepp_tpu_torch.query import kernels
from krepp_tpu_torch.tools import probe_microbench

torch.set_num_threads(1)


def _inputs(rng, nrows, width, n):
    tab = rng.integers(0, 2 ** 32, (nrows, width), dtype=np.uint32)
    idx = rng.integers(0, nrows, n).astype(np.int32)
    return tab, idx


def _t(tab, idx):
    return torch.from_numpy(tab.view(np.int32)), torch.from_numpy(idx)


@pytest.mark.parametrize("nrows,width,n,rows", [
    (4096, 5, 1001, 256),      # the bucket-row width, n not a tile multiple
    (777, 1, 513, 512),        # width 1
    (300, 9, 2000, 1),         # width 9, one row per block
    (64, 5, 0, 256),           # no rows
])
def test_ref_matches_the_numpy_gather(nrows, width, n, rows):
    rng = np.random.default_rng(nrows + width + n)
    tab, idx = _inputs(rng, nrows, width, n)
    got = kernels.dma_gather_ref(*_t(tab, idx), rows)
    assert got.dtype == torch.int32 and got.shape == (n, width)
    assert np.array_equal(got.numpy().view(np.uint32), tab[idx])


# the tiling's edges: rows_per_block at its ends and off a power of two, n
# below one tile, blocks whose run of the output starts off a 16-byte line
# (odd rows x width), the largest tile (1024 rows x 9 words), a row of more
# words than a block has threads
EDGE_SHAPES = [
    (512, 1, 700, 1), (512, 1, 700, 3), (512, 1, 5000, 1024),
    (512, 4, 700, 1), (512, 4, 700, 3), (512, 4, 5000, 1024),
    (512, 5, 700, 1), (512, 5, 700, 3), (512, 5, 5000, 1024),
    (512, 9, 700, 1), (512, 9, 700, 3), (512, 9, 5000, 1024),
    (512, 5, 100, 256), (512, 5, 1, 1024), (16, 4099, 37, 256),
    (16, 9000, 5, 3),
]


@pytest.mark.parametrize("nrows,width,n,rows", EDGE_SHAPES)
def test_tiling_never_changes_the_result(nrows, width, n, rows):
    """rows_per_block is a hint: the plain version and the host wrapper
    give tab[idx] whatever it is."""
    rng = np.random.default_rng(nrows * 7 + width * 5 + n * 3 + rows)
    tab, idx = _inputs(rng, nrows, width, n)
    want = tab[idx]
    for fn in (kernels.dma_gather_ref, kernels.dma_gather):
        got = fn(*_t(tab, idx), rows)
        assert got.dtype == torch.int32 and got.shape == (n, width)
        assert np.array_equal(got.numpy().view(np.uint32), want)


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(1)
    args = _t(*_inputs(rng, 2048, 5, 3000))
    before = kernels.dma_gather.launches
    got = kernels.dma_gather(*args, 512)
    assert kernels.dma_gather.launches == before
    assert torch.equal(got, kernels.dma_gather_ref(*args))


@pytest.mark.parametrize("case", ["dtype", "rows_per_block", "width",
                                  "out_of_range"])
def test_rejects_what_the_kernel_does_not_take(case):
    tab = torch.zeros((16, 5), dtype=torch.int32)
    idx = torch.zeros((8,), dtype=torch.int32)
    rows = 256
    if case == "dtype":
        idx = idx.to(torch.int64)
    elif case == "rows_per_block":
        rows = 2048
    elif case == "width":
        tab = torch.zeros((16, 0), dtype=torch.int32)
    else:
        idx[3] = 16
    with pytest.raises((TypeError, ValueError, IndexError)):
        kernels.dma_gather(tab, idx, rows)


def test_microbench_runs_tiny_on_the_cpu():
    out = io.StringIO()
    res = probe_microbench.run("cpu", n_idx=8000, n_dma=1001,
                               tab_rows=(1024, 4096), n_segments=16,
                               reps=1, out=out)
    text = out.getvalue()
    assert text.startswith("device: cpu\n")
    for label in ("null op", "gather [1k rows x 5 u32] 8k idx",
                  "gather [4k rows x 5 u32] 8k idx", "sort 8k u32 key",
                  "sort 8k u32 key + 1 payload", "sort 2k key + 1 payload",
                  "sort 1k key + 1 payload", "sort 500 key + 1 payload",
                  "2-key sort 500", "scatter [8k x 6 u32]",
                  "segment_sum 8k->16 sorted",
                  "onehot join 8k x 512 rows x 20 u8planes",
                  "plain gather [1k x 5 u32]",
                  "DMA gather [1k x 5 u32] tile 256",
                  "DMA gather [1k x 5 u32] tile 512"):
        assert label in res and res[label] > 0, label
        assert label in text
    assert len(res) == 15


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    rng = np.random.default_rng(5)
    before, launched = kernels.dma_gather.launches, 0
    shapes = [(2 << 20, 5, 1 << 20, 256), (2 << 20, 5, 1000003, 512),
              (1000, 1, 777, 256), (5000, 9, 4099, 1),
              (100, 5, 0, 256)] + EDGE_SHAPES
    for nrows, width, n, rows in shapes:
        tab, idx = (a.cuda() for a in _t(*_inputs(rng, nrows, width, n)))
        got = kernels.dma_gather(tab, idx, rows)
        torch.cuda.synchronize()
        assert torch.equal(got, kernels.dma_gather_ref(tab, idx, rows)), \
            (nrows, width, n, rows)
        launched += n > 0
    assert kernels.dma_gather.launches == before + launched


@pytest.mark.cuda
def test_cuda_kernel_traps_on_an_index_out_of_range():
    """Run last in its process: a trap leaves the CUDA context unusable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import subprocess
    import sys

    code = ("import torch\n"
            "from krepp_tpu_torch.query import kernels\n"
            "tab = torch.zeros((64, 5), dtype=torch.int32, device='cuda')\n"
            "idx = torch.zeros((1000,), dtype=torch.int32, device='cuda')\n"
            "kernels.dma_gather(tab, idx)\n"
            "torch.cuda.synchronize()\n"
            "idx[777] = 64\n"
            "kernels.dma_gather(tab, idx)\n"
            "try:\n"
            "    torch.cuda.synchronize()\n"
            "except Exception as e:\n"
            "    print('TRAPPED', type(e).__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert "TRAPPED" in out.stdout, out.stdout + out.stderr
