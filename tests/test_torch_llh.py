"""Port likelihoods and Brent vs krepp_tpu's, within 5e-9 (the bar of
tests/test_llh.py; it covers 1-ulp `log` differences between XLA and
ATen)."""

import numpy as np
import torch

import jax.numpy as jnp

from krepp_tpu.core import llh as jllh
from krepp_tpu_torch.core import llh

torch.set_num_threads(1)

TOL = 5e-9
K, H, TH = 27, 11, 4


def _lanes(rng, n):
    hist = rng.integers(0, 30, (n, TH + 1)).astype(np.float64)
    hist[: n // 4] = 0.0                  # some lanes without matches
    uc = rng.integers(0, 120, n).astype(np.float64)
    rho = rng.uniform(0.1, 1.0, n)
    return hist, uc, rho


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def test_make_llh_matches():
    rng = np.random.default_rng(0)
    hist, uc, rho = _lanes(rng, 200)
    d = rng.uniform(1e-6, 0.45, 200)
    want = np.asarray(jllh.make_llh(K, H, TH)(
        jnp.asarray(d), jnp.asarray(hist), jnp.asarray(uc), jnp.asarray(rho)))
    got = llh.make_llh(K, H, TH)(_t(d), _t(hist), _t(uc), _t(rho)).numpy()
    assert np.allclose(got, want, rtol=TOL, atol=TOL)


def test_make_llh_fast_matches():
    rng = np.random.default_rng(1)
    hist, uc, rho = _lanes(rng, 200)
    d = rng.uniform(1e-6, 0.45, 200)
    A = hist.sum(-1)
    Bx = (hist * np.arange(TH + 1)).sum(-1)
    want = np.asarray(jllh.make_llh_fast(K, H, TH)(
        jnp.asarray(d), jnp.asarray(A), jnp.asarray(Bx), jnp.asarray(uc),
        jnp.asarray(rho)))
    got = llh.make_llh_fast(K, H, TH)(_t(d), _t(A), _t(Bx), _t(uc),
                                      _t(rho)).numpy()
    assert np.allclose(got, want, rtol=TOL, atol=TOL)


def test_make_llh_np_is_the_reference_copy():
    rng = np.random.default_rng(2)
    hist, uc, rho = _lanes(rng, 50)
    d = rng.uniform(1e-6, 0.45, 50)
    want = jllh.make_llh_np(K, H, TH)(d, hist, uc, rho)
    got = llh.make_llh_np(K, H, TH)(d, hist, uc, rho)
    assert np.array_equal(want, got)


def test_brent_find_minima_matches():
    rng = np.random.default_rng(3)
    hist, uc, rho = _lanes(rng, 128)
    jf = jllh.make_llh(K, H, TH)
    tf = llh.make_llh(K, H, TH)
    jh, ju, jr = jnp.asarray(hist), jnp.asarray(uc), jnp.asarray(rho)
    wd, wv = jllh.brent_find_minima(lambda d: jf(d, jh, ju, jr), (128,))
    th_, tu, tr = _t(hist), _t(uc), _t(rho)
    gd, gv = llh.brent_find_minima(lambda d: tf(d, th_, tu, tr), (128,),
                                   torch.device("cpu"))
    assert np.allclose(gd.numpy(), np.asarray(wd), rtol=0, atol=TOL)
    assert np.allclose(gv.numpy(), np.asarray(wv), rtol=TOL, atol=TOL)


def test_brent_on_mask_matches():
    rng = np.random.default_rng(4)
    hist, uc, rho = _lanes(rng, 600)
    A = hist.sum(-1)
    Bx = (hist * np.arange(TH + 1)).sum(-1)
    mask = rng.random(600) < 0.3
    wd, wv = jllh.brent_on_mask(
        jllh.make_llh_fast(K, H, TH), jnp.asarray(A), jnp.asarray(Bx),
        jnp.asarray(uc), jnp.asarray(rho), jnp.asarray(mask),
        cap_divisors=(4, 2))
    gd, gv = llh.brent_on_mask(llh.make_llh_fast(K, H, TH), _t(A), _t(Bx),
                               _t(uc), _t(rho), torch.from_numpy(mask))
    assert np.allclose(gd.numpy(), np.asarray(wd), rtol=0, atol=TOL)
    assert np.allclose(gv.numpy(), np.asarray(wv), rtol=TOL, atol=TOL)
    assert not gd.numpy()[~mask].any() and gd.numpy()[mask].all()
