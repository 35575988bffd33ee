"""brent_llh's contract on the host: the wrapper takes the plain form there
(bit for bit), the plain form agrees with krepp_tpu's brent_on_mask within
the 5e-9 of tests/test_llh.py, unselected lanes are exactly 0.0, the
wrapper refuses what the kernel does not take, and the build table gives
csrc/brent_llh.cu its own flags. The kernel itself runs only on a card
(chip_smoke.py holds it against the plain form there)."""

import fnmatch
import os
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
