"""Port index build, layout and artifacts vs krepp_tpu's, field by field;
and the no-JAX import boundary of the port."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from krepp_tpu import testing as jtesting
from krepp_tpu.index import artifact as jartifact
from krepp_tpu.index.index import DeviceIndex as JDeviceIndex
from krepp_tpu_torch import testing
from krepp_tpu_torch.index import artifact
from krepp_tpu_torch.index.index import DeviceIndex

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORLDS = {
    # dense unified rows (k=27 h=11 m=2)
    "dense": dict(seed=5, nleaves=6, glen=3000, k=27, h=11, m=2),
    # reference defaults k=29 h=13 m=4: sparse rows (row_ids set) and a
    # per-entry-row build (inc is None)
    "sparse": dict(seed=6, nleaves=6, glen=3000, k=29, h=13, m=4),
}


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request):
    kw = WORLDS[request.param]
    jbuilt, _, _ = jtesting.build_world_index(**kw)
    tbuilt, _, _ = testing.build_world_index(**kw)
    return request.param, jbuilt, tbuilt


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


def _fields(x):
    """A dataclass as a dict: the port's params classes are its own copies,
    equal to the reference's field by field, not by class."""
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def _assert_device_index_equal(want, got):
    for f in ("resident", "res_rank", "row_start", "enc_v", "se_v",
              "leaf_ses", "rho_slot", "se_mask", "row_ids", "leaf_csr_off",
              "leaf_csr_slots"):
        assert _same(getattr(want, f), getattr(got, f)), f
    for f in ("R", "nrows_u", "max_bucket", "wbackbone", "names",
              "slot_of_se", "lsh"):
        assert _fields(getattr(want, f)) == _fields(getattr(got, f)), f
    assert np.array_equal(want.colors.rho, got.colors.rho)


def test_build_matches_reference(world):
    name, jb, tb = world
    for f in ("enc_v", "se_v", "inc", "rows_local"):
        assert _same(getattr(jb, f), getattr(tb, f)), f
    assert (tb.inc is None) == (name == "sparse")
    for f in ("leaf_off", "leaf_list", "rho"):
        assert np.array_equal(getattr(jb.colors, f), getattr(tb.colors, f))
    assert jb.names == tb.names
    assert _fields(jb.params) == _fields(tb.params)


def test_dedupe_genome_matches_reference():
    from krepp_tpu.index.build import _dedupe_genome as jdedupe
    from krepp_tpu_torch.index.build import _dedupe_genome

    rng = np.random.default_rng(9)
    rows = rng.integers(0, 50, 400).astype(np.uint32)
    res = rng.integers(0, 4, 400).astype(np.uint32)
    for a, b in zip(jdedupe(rows, res), _dedupe_genome(rows, res)):
        assert np.array_equal(a, b)


def test_device_index_matches_reference(world):
    name, jb, tb = world
    want = JDeviceIndex.from_built(jb)
    got = DeviceIndex.from_built(tb)
    _assert_device_index_equal(want, got)
    assert (got.row_ids is not None) == (name == "sparse")


def test_reference_artifact_loads_in_the_port(world, tmp_path):
    _, jb, _ = world
    jartifact.save_native(jb, str(tmp_path / "idx"))
    want = jartifact.load_native_device(str(tmp_path / "idx"))
    got = artifact.load_native_device(str(tmp_path / "idx"))
    _assert_device_index_equal(want, got)
    assert got.res_info == want.res_info


def test_port_artifact_loads_in_the_reference(world, tmp_path):
    _, jb, tb = world
    artifact.save_native(tb, str(tmp_path / "idx"))
    want = JDeviceIndex.from_built(jb)
    got = jartifact.load_native_device(str(tmp_path / "idx"))
    _assert_device_index_equal(want, got)


def test_from_reference_carries_the_state(world):
    _, jb, _ = world
    ref = JDeviceIndex.from_built(jb)
    got = DeviceIndex.from_reference(ref)
    assert isinstance(got, DeviceIndex)
    _assert_device_index_equal(ref, got)


@pytest.mark.parametrize("nleaves,W", [(48, 2), (256, 8)])
def test_from_reference_carries_wide_indexes(nleaves, W):
    jb, _, _ = jtesting.build_world_index(seed=nleaves, nleaves=nleaves,
                                          glen=400, m=2)
    ref = JDeviceIndex.from_built(jb)
    got = DeviceIndex.from_reference(ref)
    assert got.se_mask.shape[1] == W and got.nleafslots == nleaves
    _assert_device_index_equal(ref, got)


def test_multi_partial_and_reference_formats_raise(tmp_path):
    multi = tmp_path / "multi"
    multi.mkdir()
    (multi / "meta-m4r1-frac.json").write_text("{}")
    with pytest.raises(NotImplementedError):
        artifact.load_index(str(multi))
    ref = tmp_path / "ref"
    ref.mkdir()
    (ref / "cmer-m4r1-frac").write_bytes(b"")
    with pytest.raises(NotImplementedError):
        artifact.load_index(str(ref))


_BLOCK_JAX = r"""
import importlib, pkgutil, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "krepp_tpu"):
            raise ImportError(name + " is blocked")

sys.meta_path.insert(0, _Block())
import krepp_tpu_torch
mods = ["krepp_tpu_torch"]
for m in pkgutil.walk_packages(krepp_tpu_torch.__path__, "krepp_tpu_torch."):
    importlib.import_module(m.name)
    mods.append(m.name)
assert not any(n.split(".")[0] in ("jax", "jaxlib", "krepp_tpu")
               for n in sys.modules)
print(len(mods))
"""


def test_port_imports_with_jax_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _BLOCK_JAX], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from krepp_tpu_torch import resolve_device

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
