"""probe_hist_packed: the port's plain version vs the Pallas kernel
(interpret mode on the CPU), and the CUDA kernel vs the plain version on a
card. Integer outputs must be equal.

JAX is imported inside the parity test only, so that the card's machine
(which has no JAX) can run the cuda-marked test:
    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from krepp_tpu_torch.query import kernels
from krepp_tpu_torch.testing import epilogue_inputs as _inputs

torch.set_num_threads(1)


def _torch_args(res, light, d):
    return (torch.from_numpy(res.view(np.int32)), torch.from_numpy(light),
            torch.from_numpy(d.view(np.int32)))


@pytest.mark.parametrize("N,P,C0,S,th", [
    (300, 166, 2, 24, 4),     # main path shape (N not a multiple of 256)
    (257, 255, 2, 32, 5),     # P = 255, S = 32, X = 6
    (100, 166, 1, 24, 4),     # one dense slot
    (513, 200, 1, 32, 5),
])
def test_ref_matches_pallas_interpret(N, P, C0, S, th):
    import jax.numpy as jnp

    from krepp_tpu.query.pallas_kernels import probe_hist_packed as jax_packed

    rng = np.random.default_rng(N + P + C0 + S + th)
    res, light, d = _inputs(rng, N, P, C0, S, th)
    ents = []
    for c in range(C0):
        ents += [jnp.asarray(d[..., 1 + 2 * c]), jnp.asarray(d[..., 2 + 2 * c])]
    want_h, want_m = jax_packed(jnp.asarray(res), jnp.asarray(light),
                                tuple(ents), th, C0, S, interpret=True)
    got_h, got_m = kernels.probe_hist_packed_ref(*_torch_args(res, light, d),
                                                 th, C0, S)
    assert np.array_equal(np.asarray(want_h), got_h.numpy())
    assert np.array_equal(np.asarray(want_m), got_m.numpy())
    assert got_h.sum() > 0 and (got_m.numpy() < 255).any()


# shapes the CUDA kernel's staging makes delicate: row spans of P * 20 bytes
# that are not multiples of 16, one row, fewer rows than a block takes,
# every leaf set, leaf S - 1 alone
STAGING_CASES = [  # (N, P, C0, S, th, leafsets)
    (37, 1, 2, 24, 4, "random"),
    (29, 122, 2, 24, 4, "random"),
    (31, 166, 2, 32, 4, "dense"),
    (13, 255, 2, 24, 4, "random"),
    (1, 166, 2, 24, 4, "random"),
    (23, 166, 2, 24, 4, "last"),
    (17, 33, 1, 1, 0, "random"),
]


@pytest.mark.parametrize("N,P,C0,S,th,leafsets", STAGING_CASES)
def test_ref_matches_pallas_on_staging_shapes(N, P, C0, S, th, leafsets):
    import jax.numpy as jnp

    from krepp_tpu.query.pallas_kernels import probe_hist_packed as jax_packed

    rng = np.random.default_rng(1000 + N + P + S)
    res, light, d = _inputs(rng, N, P, C0, S, th, False, leafsets)
    ents = []
    for c in range(C0):
        ents += [jnp.asarray(d[..., 1 + 2 * c]), jnp.asarray(d[..., 2 + 2 * c])]
    want_h, want_m = jax_packed(jnp.asarray(res), jnp.asarray(light),
                                tuple(ents), th, C0, S, interpret=True)
    got_h, got_m = kernels.probe_hist_packed_ref(*_torch_args(res, light, d),
                                                 th, C0, S)
    assert np.array_equal(np.asarray(want_h), got_h.numpy())
    assert np.array_equal(np.asarray(want_m), got_m.numpy())
    assert got_h.sum() > 0 and (got_m.numpy() < 255).any()
    if leafsets == "last":
        assert int(got_h[:, :S - 1].sum()) == 0


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(3)
    args = _torch_args(*_inputs(rng, 64, 166, 2, 24, 4))
    before = kernels.probe_hist_packed.launches
    got = kernels.probe_hist_packed(*args, 4, 2, 24)
    want = kernels.probe_hist_packed_ref(*args, 4, 2, 24)
    assert kernels.probe_hist_packed.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_all_dark_rows_report_no_match():
    rng = np.random.default_rng(4)
    args = _torch_args(*_inputs(rng, 40, 166, 2, 24, 4, dark=True))
    hist, minall = kernels.probe_hist_packed_ref(*args, 4, 2, 24)
    assert int(hist.sum()) == 0 and bool((minall == 255).all())


@pytest.mark.parametrize("P,S,th", [(256, 24, 4), (166, 33, 4),
                                    (166, 24, 6)])
def test_rejects_shapes_outside_the_kernel_gate(P, S, th):
    res = torch.zeros((4, P), dtype=torch.int32)
    light = torch.zeros((4, P), dtype=torch.bool)
    d = torch.zeros((4, P, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.probe_hist_packed(res, light, d, th, 2, S)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    rng = np.random.default_rng(5)
    cases = [(32768, 166, 2, 24, 4, "random"), (1000, 255, 2, 32, 5, "random"),
             (777, 166, 1, 24, 4, "random")] + STAGING_CASES
    for (N, P, C0, S, th, leafsets) in cases:
        args = _torch_args(*_inputs(rng, N, P, C0, S, th, False, leafsets))
        want = kernels.probe_hist_packed_ref(*args, th, C0, S)
        got = kernels.probe_hist_packed(*(a.cuda() for a in args), th, C0, S)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    # the measurement hook keeps the next launch's arguments, once
    args = tuple(a.cuda() for a in _torch_args(*_inputs(rng, 9, 166, 2, 24,
                                                         4)))
    kernels.probe_hist_packed.keep_next = True
    kernels.probe_hist_packed(*args, 4, 2, 24)
    kept = kernels.probe_hist_packed.kept
    kernels.probe_hist_packed.kept = None
    assert not kernels.probe_hist_packed.keep_next and kept[3:] == (4, 2, 24)
    assert all(torch.equal(a, b) for a, b in zip(kept[:3], args))
