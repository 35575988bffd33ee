"""The port's multi-device index build against its sequential build and
against krepp_tpu's sharded build, on the worlds of tests/test_sharded_build.py
(7 leaves; several contigs per genome with one shorter than w) and on a
world with tiled contigs and a host-fallback contig. The port's devices are
the host taken D times (`[cpu] * D`), which cuts batches of tiles into D
pieces exactly as D cards would; krepp_tpu runs on the CPU's virtual
devices. Tolerance: none, every array equal element for element and rho
equal as floats."""

import jax
import numpy as np
import pytest
import torch

from krepp_tpu import params as jparams
from krepp_tpu.core import winnow_device as jwd
from krepp_tpu.parallel import build as jsharded
from krepp_tpu.tree.newick import Tree as JTree
from krepp_tpu_torch import params
from krepp_tpu_torch.core import winnow_device
from krepp_tpu_torch.core.codec import seq_to_codes
from krepp_tpu_torch.index.build import build_index
from krepp_tpu_torch.parallel import build as sharded
from krepp_tpu_torch.tree.newick import Tree

import worldgen
from test_e2e_dist import write_world
from refcsrc import private_reference_csrc  # noqa: F401

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _params(mod, k, h, w, m, r, seed):
    return mod.IndexParams(lsh=mod.LSHParams.generate(k, h, m, seed=seed),
                           w=w, r=r, frac=True)


def _assert_built_equal(want, got):
    for f in ("enc_v", "se_v", "inc"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("leaf_off", "leaf_list", "rho"):
        a, b = getattr(want.colors, f), getattr(got.colors, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert want.names == got.names and got.nkmers > 300


@pytest.fixture(scope="module")
def seven_leaves(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sharded_7")
    rng = np.random.default_rng(41)
    nwk, genomes = worldgen.make_world(rng, nleaves=7, glen=2200, rate=0.05)
    return write_world(d, genomes), nwk, (27, 11, 35, 4, 1, 5)


@pytest.fixture(scope="module")
def multicontig(tmp_path_factory):
    """Three contigs per genome, one of them shorter than w (skipped)."""
    d = tmp_path_factory.mktemp("torch_sharded_multi")
    rng = np.random.default_rng(17)
    nwk, genomes = worldgen.make_world(rng, nleaves=4, glen=1800, rate=0.05)
    input_map = []
    for name, seqs in sorted(genomes.items()):
        seq = seqs[0]
        p = d / f"{name}.fna"
        with open(p, "w") as f:
            f.write(f">{name}-a\n{seq[:900]}\n")
            f.write(f">{name}-tiny\n{seq[900:920]}\n")
            f.write(f">{name}-b\n{seq[920:]}\n")
        input_map.append((name, str(p)))
    return input_map, nwk, (23, 9, 31, 2, 0, 2)


@pytest.fixture(scope="module")
def references(seven_leaves, multicontig):
    """Each world through krepp_tpu's sharded build (8 and 4 devices) and
    the port's sequential build (the C winnower)."""
    out = {}
    for tag, world, D in (("seven", seven_leaves, 8),
                          ("multi", multicontig, 4)):
        input_map, nwk, cfg = world
        assert len(jax.devices()) >= D
        out[tag] = (
            jsharded.build_index_sharded(
                input_map, _params(jparams, *cfg), JTree.parse(nwk),
                devices=jax.devices()[:D], progress=False),
            build_index(input_map, _params(params, *cfg), Tree.parse(nwk),
                        progress=False, device="cpu"))
    return out


@pytest.mark.parametrize("D", [1, 4, 8])
@pytest.mark.parametrize("tag", ["seven", "multi"])
def test_sharded_build_equals_sequential_and_reference(
        request, references, tag, D):
    input_map, nwk, cfg = request.getfixturevalue(
        "seven_leaves" if tag == "seven" else "multicontig")
    got = sharded.build_index_sharded(
        input_map, _params(params, *cfg), Tree.parse(nwk),
        devices=[CPU] * D, progress=False)
    for want in references[tag]:
        _assert_built_equal(want, got)


def test_sharded_build_tiles_long_contigs_and_falls_back(monkeypatch,
                                                         tmp_path, capsys):
    """Tiles of 2048 bases in both packages: contigs of several tiles, more
    batches than one (TILE_GROUP 1, two devices), a contig whose trailing
    N-run needs the exact host path, and the progress lines."""
    monkeypatch.setattr(jwd, "_CHUNK", 2048)
    monkeypatch.setattr(winnow_device, "_CHUNK", 2048)
    monkeypatch.setattr(winnow_device, "TILE_GROUP", 1)
    rng = np.random.default_rng(23)
    nwk, genomes = worldgen.make_world(rng, nleaves=3, glen=7000, rate=0.05)
    starved = genomes["G001"][0] + "N" * 2500 + genomes["G001"][0][:30]
    genomes["G001"] = [genomes["G001"][0][:5000], starved]
    input_map = write_world(tmp_path, genomes)
    cfg = (27, 11, 35, 4, 1, 5)
    tp = _params(params, *cfg)
    assert winnow_device.contig_tiles(seq_to_codes(starved), tp) is None
    assert len(winnow_device.contig_tiles(np.zeros(7000, np.uint8), tp)) == 4
    want = jsharded.build_index_sharded(
        input_map, _params(jparams, *cfg), JTree.parse(nwk),
        devices=jax.devices()[:2], progress=False)
    capsys.readouterr()
    got = sharded.build_index_sharded(input_map, tp, Tree.parse(nwk),
                                      devices=[CPU] * 2)
    _assert_built_equal(want, got)
    _assert_built_equal(build_index(input_map, tp, Tree.parse(nwk),
                                    progress=False, device="cpu"), got)
    err = capsys.readouterr().err.splitlines()
    assert [ln.split("\t")[0] for ln in err] == [
        f"Leaf node: G00{i}" for i in range(3)]
    assert err[-1].endswith("progress: 3/3 (mesh x2)")


def test_winnow_genomes_sharded_yields_in_input_order_and_skips_absent():
    rng = np.random.default_rng(29)
    tp = _params(params, 27, 11, 35, 4, 1, 5)
    contigs = {n: [rng.integers(0, 4, 1500).astype(np.uint8),
                   rng.integers(0, 5, 900).astype(np.uint8)]
               for n in ("b", "a", "c")}
    sources = {n: (lambda n=n: iter(contigs[n])) for n in contigs}
    out = list(sharded.winnow_genomes_sharded(
        ["b", "missing", "a", "c"], sources, tp, [CPU] * 3, progress=False))
    assert [o[0] for o in out] == ["b", "a", "c"]
    for name, rows, res, rho in out:
        want = winnow_device.extract_genome_mers_device(contigs[name], tp,
                                                        "cpu")
        assert np.array_equal(rows, want[0]) and np.array_equal(res, want[1])
        assert rho == want[2] and len(rows) > 50


def test_mesh_devices_names_the_count_it_lacks(monkeypatch):
    assert sharded.mesh_devices(3, "cpu") == [CPU] * 3
    with pytest.raises(ValueError, match="positive"):
        sharded.mesh_devices(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            sharded.mesh_devices(2, "cuda")
    # a machine with two cards, whatever this one has
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="--mesh 3 asks for 3 CUDA devices "
                                           "but this machine has 2"):
        sharded.mesh_devices(3, "cuda")
    assert sharded.mesh_devices(2) == [torch.device("cuda", 0),
                                       torch.device("cuda", 1)]
