"""brent_llh's contract on the host: the wrapper takes the plain form there
(bit for bit), the plain form agrees with krepp_tpu's brent_on_mask within
the 5e-9 of tests/test_llh.py, unselected lanes are exactly 0.0, a lane's
bits and steps do not depend on the order of the lanes, the per-lane step
hook counts each lane, the wrapper refuses what the kernel does not take,
its binomial table fits the kernel's parameters, and the build table gives
csrc/brent_llh.cu its own flags. The kernel itself runs only on a card
(chip_smoke.py holds it against the plain form there)."""

import fnmatch
import os
import re
import tomllib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krepp_tpu.core import llh as jllh
from krepp_tpu_torch.core import llh
from krepp_tpu_torch.csrc import build
from krepp_tpu_torch.testing import brent_inputs

torch.set_num_threads(1)

TOL = 5e-9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KH = [(27, 11), (29, 13)]
THS = [0, 2, 4, 7]


def _lanes(rng, n, th):
    """(A, Bx, uc, rho) of n lanes (testing.brent_inputs)."""
    return brent_inputs(rng, (n,), th)[:4]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _masks(rng, n):
    return {"random": rng.random(n) < 0.4, "all false": np.zeros(n, bool),
            "all true": np.ones(n, bool), "none": None}


def _jax(k, h, th, A, Bx, uc, rho, mask):
    if mask is None:
        mask = np.ones(uc.shape, bool)
    d, v = jllh.brent_on_mask(jllh.make_llh_fast(k, h, th), jnp.asarray(A),
                              jnp.asarray(Bx), jnp.asarray(uc),
                              jnp.asarray(rho), jnp.asarray(mask))
    return np.asarray(d), np.asarray(v)


@pytest.mark.parametrize("th", THS)
@pytest.mark.parametrize("k,h", KH)
def test_brent_llh_on_the_host_is_the_plain_form(k, h, th):
    rng = np.random.default_rng(100 * k + th)
    lanes = [_t(a) for a in _lanes(rng, 300, th)]
    before = llh.brent_llh.launches
    for mask in _masks(rng, 300).values():
        m = None if mask is None else _t(mask)
        got = llh.brent_llh(*lanes, m, k, h, th)
        want = llh.brent_llh_ref(*lanes, m, k, h, th)
        for g, w in zip(got, want):
            assert g.dtype == torch.float64 and g.shape == (300,)
            assert torch.equal(g.view(torch.int64), w.view(torch.int64))
    assert llh.brent_llh.launches == before       # no kernel on the host


@pytest.mark.parametrize("th", THS)
@pytest.mark.parametrize("k,h", KH)
def test_brent_llh_ref_matches_reference(k, h, th):
    rng = np.random.default_rng(200 * k + th)
    A, Bx, uc, rho = _lanes(rng, 300, th)
    for name, mask in _masks(rng, 300).items():
        gd, gv = llh.brent_llh_ref(_t(A), _t(Bx), _t(uc), _t(rho),
                                   None if mask is None else _t(mask), k, h,
                                   th)
        wd, wv = _jax(k, h, th, A, Bx, uc, rho, mask)
        assert np.allclose(gd.numpy(), wd, rtol=0, atol=TOL), name
        assert np.allclose(gv.numpy(), wv, rtol=TOL, atol=TOL), name
        sel = np.ones(300, bool) if mask is None else mask
        assert not gd.numpy()[~sel].any() and gd.numpy()[sel].all(), name
        d = gd.numpy()[sel]
        assert ((d >= 1e-10) & (d <= 0.5)).all(), name


@pytest.mark.parametrize("th", THS)
@pytest.mark.parametrize("k,h", KH)
def test_brent_llh_unselected_lanes_are_zero(k, h, th):
    """A [B, Q] mask, as place's dense stage 3 passes: the shape is kept,
    unselected lanes are exactly +0.0 (sign bit clear), and a selected
    lane's value does not depend on its neighbours."""
    rng = np.random.default_rng(300 * k + th)
    *lanes, mask = brent_inputs(rng, (12, 25), th)
    d, v = llh.brent_llh(*(_t(a) for a in lanes), _t(mask), k, h, th)
    assert d.shape == v.shape == (12, 25)
    for out in (d, v):
        bits = out.view(torch.int64).numpy()
        assert (bits[~mask] == 0).all()
    alone_d, alone_v = llh.brent_llh(*(_t(a[mask]) for a in lanes), None, k,
                                     h, th)
    assert torch.equal(alone_d, d[_t(mask)]) and torch.equal(alone_v,
                                                             v[_t(mask)])


def _bits(t):
    return t.view(torch.int64)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("th", THS)
def test_brent_llh_ref_lanes_do_not_depend_on_their_order(th, masked):
    """The plain form gives each lane the same bits, and takes the same
    steps on it, whatever the order of the lanes: a kernel may take the
    lanes in any order (the property a lane queue or a regrouping of lanes
    by step count relies on)."""
    rng = np.random.default_rng(400 + 10 * th + masked)
    *lanes, mask = brent_inputs(rng, (500,), th)
    perm = rng.permutation(500)
    runs = []
    for order in (np.arange(500), perm):
        args = [_t(a[order]) for a in lanes]
        m = _t(mask[order]) if masked else None
        llh.brent_find_minima.lane_steps = []
        try:
            d, v = llh.brent_llh_ref(*args, m, 29, 13, th)
            (steps,) = llh.brent_find_minima.lane_steps
        finally:
            llh.brent_find_minima.lane_steps = None
        # steps are over the selected lanes, in their order
        sel = order[mask[order]] if masked else order
        full = torch.full((500,), -1, dtype=torch.int64)
        full[_t(sel)] = steps
        back = torch.empty(500, dtype=torch.int64)
        back[_t(order)] = torch.arange(500)
        runs.append((d[back], v[back], full))
    (d0, v0, s0), (d1, v1, s1) = runs
    assert torch.equal(_bits(d0), _bits(d1))
    assert torch.equal(_bits(v0), _bits(v1))
    selected = _t(mask) if masked else torch.ones(500, dtype=torch.bool)
    assert torch.equal(s0, s1) and torch.equal(s0 >= 2, selected)


def test_brent_lane_steps_hook_counts_each_lane():
    """The per-lane hook chip_smoke.py's latency floor and its mixed-warp
    case read: a lane whose likelihood is NaN stops after 2 steps (the
    fewest any lane can take: the first step is always the golden step
    from 0.5, after which the bracket is wider than 0.19), the lanes
    chip_smoke.py names as the longest runs known take 58, and the hook
    left unset records nothing."""
    import chip_smoke

    rows = [chip_smoke.BRENT_SHORT_LANE] + list(chip_smoke.BRENT_LONG_LANES)
    args = [torch.tensor([r[j] for r in rows], dtype=torch.float64)
            for j in range(4)]
    llh.brent_find_minima.lane_steps = []
    try:
        d, v = llh.brent_llh_ref(*args, None, 29, 13, 4)
        (steps,) = llh.brent_find_minima.lane_steps
    finally:
        llh.brent_find_minima.lane_steps = None
    longest = chip_smoke.BRENT_LONGEST_STEPS
    assert steps.tolist() == [2] + [longest] * len(chip_smoke.BRENT_LONG_LANES)
    assert torch.isnan(v[0]) and d[0] == 0.5
    llh.brent_llh_ref(*args, None, 29, 13, 4)
    assert llh.brent_find_minima.lane_steps is None


def test_chip_smoke_brent_bound_reads_the_inputs_of_selected_lanes_only():
    """chip_smoke.py's byte bound of brent_llh: the mask read and d, v
    written for every lane, A, Bx, uc and rho read for the selected lanes
    only (all of them when the mask is None); its operations follow the
    lane-steps."""
    import chip_smoke

    n, sel, each = 1000, 300, 10
    f = torch.zeros(n, dtype=torch.float64)
    m = torch.zeros(n, dtype=torch.bool)
    m[:sel] = True
    steps = torch.full((sel,), each)
    _, _, ops, moved = chip_smoke.brent_bound((f, f, f, f, m, 29, 13, 4),
                                              steps)
    assert moved == n + 16 * n + 32 * sel
    assert ops == (sel + sel * each) * chip_smoke.brent_llh_ops(29, 4) \
        + sel * each * chip_smoke.BRENT_STEP_OPS
    _, _, _, moved = chip_smoke.brent_bound((f, f, f, f, None, 29, 13, 4),
                                            torch.full((n,), each))
    assert moved == 48 * n


def test_chip_smoke_reads_one_kernel_instance_from_ptxas():
    """The registers and spill bytes of brent_llh_kernel<4> come from its
    own entry of an `nvcc -Xptxas -v` log, not from a neighbour's."""
    import chip_smoke

    def entry(th, regs, stores, loads):
        name = f"_ZN12_GLOBAL__N_116brent_llh_kernelILi{th}EEEvPKdS2_"
        return (f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'\nptxas info    : Function properties for {name}\n"
                f"    0 bytes stack frame, {stores} bytes spill stores, "
                f"{loads} bytes spill loads\nptxas info    : Used {regs} "
                "registers, used 1 barriers\n")

    log = entry(5, 80, 0, 0) + entry(4, 76, 8, 12) + entry(3, 70, 0, 0)
    assert chip_smoke.ptxas_usage(log, "brent_llh_kernelILi4EE") == (76, 8, 12)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.ptxas_usage(log, "brent_llh_kernelILi7EE")


def test_brent_llh_binomial_table_fits_the_kernel_parameters():
    """The launcher copies binom_k[0..th] and binom_hnk[0..th] from the
    host table the wrapper passes into the kernel's parameter struct of
    kMaxTh + 1 entries each: the table holds 2 (th + 1) f64 in that order,
    contiguous, for every th the wrapper accepts, and the wrapper's k and
    th limits are the kernel's."""
    with open(os.path.join(build.CSRC_DIR, "brent_llh.cu")) as f:
        text = f.read()
    max_th = int(re.search(r"constexpr int kMaxTh = (\d+);", text)[1])
    assert "double k[kMaxTh + 1];" in text and "double h[kMaxTh + 1];" in text
    assert llh.MAX_BRENT_K == max_th == 32
    for k, h in KH + [(32, 13), (1, 1)]:
        for th in range(k + 1):
            tab = llh._binom_host(k, h, th)
            binom_k, binom_hnk = llh.binom_tables(k, h, th)
            assert tab.dtype == np.float64 and tab.flags["C_CONTIGUOUS"]
            assert tab.shape == (2 * (th + 1),) and th + 1 <= max_th + 1
            assert np.array_equal(tab[: th + 1], binom_k[: th + 1])
            assert np.array_equal(tab[th + 1:], binom_hnk)


@pytest.mark.parametrize("mask", [None, "empty"])
def test_brent_llh_on_no_lanes(mask):
    e = torch.zeros(0, dtype=torch.float64)
    m = None if mask is None else torch.zeros(0, dtype=torch.bool)
    d, v = llh.brent_llh(e, e, e, e, m, 29, 13, 4)
    assert d.shape == v.shape == (0,) and d.dtype == torch.float64
    wd, wv = _jax(29, 13, 4, *(np.zeros(0),) * 4,
                  None if m is None else np.zeros(0, bool))
    assert wd.shape == wv.shape == (0,)


def test_brent_llh_refuses_what_the_kernel_does_not_take():
    f = torch.ones(8, dtype=torch.float64)
    m = torch.ones(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        llh.brent_llh(f.float(), f, f, f, m, 29, 13, 4)
    with pytest.raises(TypeError):
        llh.brent_llh(f, f, f, f, m.to(torch.uint8), 29, 13, 4)
    with pytest.raises(ValueError, match="shape"):
        llh.brent_llh(f, f[:7], f, f, m, 29, 13, 4)
    with pytest.raises(ValueError, match="shape"):
        llh.brent_llh(f, f, f, f, m.reshape(2, 4), 29, 13, 4)
    with pytest.raises(ValueError, match="one device"):
        llh.brent_llh(f, f.to("meta"), f, f, m, 29, 13, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        llh.brent_llh(*(f.to("meta"),) * 4, m.to("meta"), 29, 13, 4)
    with pytest.raises(ValueError, match="th=30"):
        llh.brent_llh(f, f, f, f, m, 29, 13, 30)
    with pytest.raises(ValueError, match="th=-1"):
        llh.brent_llh(f, f, f, f, m, 29, 13, -1)
    with pytest.raises(ValueError, match="k=33"):
        llh.brent_llh(f, f, f, f, m, 33, 13, 4)


def test_brent_llh_source_is_shipped_and_built_with_its_own_flags(
        monkeypatch):
    """A text test of the build table: nothing compiles here."""
    src = os.path.join(build.CSRC_DIR, "brent_llh.cu")
    with open(src) as f:
        text = f.read()
    assert 'extern "C" int krepp_brent_llh(' in text
    assert "__dadd_rn" in text and "__dmul_rn" in text
    # the binomials travel by value in the kernel's parameters, and the
    # launcher has a kernel compiled for each th of 0..7 and a generic one
    assert "const __grid_constant__ Binom bn" in text
    for th in range(8):
        assert f"case {th}: return launch<{th}>(" in text
    assert "return launch<-1>(" in text
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    shipped = [p for key, pats in data.items()
               if key.startswith("krepp_tpu_torch") for p in pats]
    assert any(fnmatch.fnmatch("csrc/brent_llh.cu", p) for p in shipped), \
        shipped
    assert build.flags("brent_llh") == build.NVCC_FLAGS + ("-fmad=false",)
    for name in ("probe_hist_packed", "probe_hist_tiles", "hdist_chunk",
                 "dma_gather"):
        assert build.flags(name) == build.NVCC_FLAGS
    # the flags are part of the library's name: without its own flag the
    # kernel would be another library, and the others' names are unchanged
    own = build._paths("brent_llh")[1]
    other = build._paths("hdist_chunk")[1]
    monkeypatch.setattr(build, "KERNEL_FLAGS", {})
    assert build._paths("brent_llh")[1] != own
    assert build._paths("hdist_chunk")[1] == other
