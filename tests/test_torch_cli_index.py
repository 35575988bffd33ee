"""The port's `index` command and the loading of every index form it
writes, against krepp_tpu's: the same genome files through both CLIs give
the same directory, and a directory written by the port loads to the same
DeviceIndex, `inspect` text and `dist` TSV in both packages; `index` and
`sketch` on their device paths (sdust masking, the device winnower, windows
wider than the C winnower's, `index --mesh N`) with --device cpu. CPU
only."""

import dataclasses
import filecmp
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from krepp_tpu import cli as jcli
from krepp_tpu.index import artifact as jartifact
from krepp_tpu_torch import cli
from krepp_tpu_torch.index import artifact

import worldgen
from test_e2e_dist import write_world
from refcsrc import private_reference_csrc  # noqa: F401

torch.set_num_threads(1)

LSH = ["-k", "27", "-h", "11", "-w", "35", "-m", "4"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Six genomes as FASTA files, the name->path TSV, the tree, reads."""
    rng = np.random.default_rng(101)
    d = tmp_path_factory.mktemp("torch_cli_index")
    nwk, genomes = worldgen.make_world(rng, nleaves=6, glen=1400, rate=0.05)
    with open(d / "map.tsv", "w") as f:
        for name, path in write_world(d, genomes):
            f.write(f"{name}\t{path}\n")
    with open(d / "tree.nwk", "w") as f:
        f.write(nwk + "\n")
    with open(d / "q.fq", "w") as f:
        for rid, seq in worldgen.sample_reads(rng, genomes, n=10, mut=0.05):
            f.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")
    return d


def _index_argv(d, out, flags, root=()):
    argv = [*root, "index", "-i", str(d / "map.tsv"), "-o", str(out), *LSH]
    for flag in flags:
        argv += ["-t", str(d / "tree.nwk")] if flag == "-t" else [flag]
    return argv


def _assert_same_directory(want_dir, got_dir):
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir))
    for name in names:
        a, b = os.path.join(want_dir, name), os.path.join(got_dir, name)
        if name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                want, got = json.load(fa), json.load(fb)
            assert sorted(want) == sorted(got)
            for key in want:
                assert want[key] == got[key], (name, key)
        elif name.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for key in za.files:
                assert za[key].dtype == zb[key].dtype, (name, key)
                assert np.array_equal(za[key], zb[key]), (name, key)
        else:
            assert filecmp.cmp(a, b, shallow=False), name
    return names


BUILDS = {
    "tree": (["-t"], ()),
    "no_tree": ([], ()),
    "partial": (["-t", "--partial"], ()),
    "no_frac_r0": (["-t", "--no-frac", "-r", "0"], ()),
    "reference_format": (["-t", "--export-reference-format"], ()),
    "no_tree_partial_reference_format": (
        ["--partial", "--no-frac", "-r", "1", "--export-reference-format"],
        ()),
    "seed_and_threads": (["-t", "--export-reference-format"],
                         ("--seed", "7", "--num-threads", "2")),
}


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_index_writes_the_reference_directory(world, tmp_path, case):
    flags, root = BUILDS[case]
    assert jcli.main(_index_argv(world, tmp_path / "want", flags, root)) == 0
    assert cli.main(_index_argv(world, tmp_path / "got", flags, root)) == 0
    names = _assert_same_directory(tmp_path / "want", tmp_path / "got")
    # without -t the build generates a tree and the native form keeps it
    assert "reflist.txt" in names and "tree.nwk" in names
    assert ("meta.json" in names) == ("--partial" not in flags)
    if "--export-reference-format" in flags:
        sfx = [n[len("cmer"):] for n in names if n.startswith("cmer-")]
        assert len(sfx) == 1
        for stem in ("crecord", "inc", "metadata", "reflist"):
            assert stem + sfx[0] in names
        assert "metadata" + sfx[0] + ".txt" in names
        assert ("tree" + sfx[0] in names) == ("-t" in flags)


def test_index_prints_the_reference_lines(world, tmp_path, capsys):
    assert jcli.main(_index_argv(world, tmp_path / "want", ["-t"])) == 0
    want = capsys.readouterr().err
    assert cli.main(_index_argv(world, tmp_path / "got", ["-t"])) == 0
    got = capsys.readouterr().err
    for text in (want, got):
        assert "Building the index...\n" in text
    line = [l for l in want.splitlines()
            if l.startswith("Total number of k-mers indexed: ")]
    assert len(line) == 1 and line[0] in got.splitlines()
    assert "krepp_tpu " not in got and "python -m krepp_tpu\n" not in got


def test_index_rejects_a_malformed_map_with_the_reference_text(world,
                                                               tmp_path):
    bad = tmp_path / "bad.tsv"
    bad.write_text("G000 refs/G000.fna\n")
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(["index", "-i", str(bad), "-o", str(tmp_path / "x"), *LSH])
        assert str(e.value) == \
            "Failed to read the reference name to path/URL mapping!"


def _planted_world(d, seed, glen):
    """Three genomes with a planted homopolymer and a planted dinucleotide
    repeat each, as FASTA files with the name->path TSV and the tree."""
    rng = np.random.default_rng(seed)
    nwk, genomes = worldgen.make_world(rng, nleaves=3, glen=glen, rate=0.05)
    for name, (seq,) in genomes.items():
        genomes[name] = [seq[:1000] + "A" * 100 + seq[1100:3000] + "AT" * 45
                         + seq[3090:]]
    with open(d / "map.tsv", "w") as f:
        for name, path in write_world(d, genomes):
            f.write(f"{name}\t{path}\n")
    with open(d / "tree.nwk", "w") as f:
        f.write(nwk + "\n")
    return d


@pytest.fixture(scope="module")
def long_world(tmp_path_factory):
    """5,000-bp genomes: the size for sdust's per-base host loop."""
    return _planted_world(tmp_path_factory.mktemp("torch_cli_index_long"),
                          103, 5000)


@pytest.fixture(scope="module")
def wide_world(tmp_path_factory):
    """20,000-bp genomes: several 4,200-bp windows each."""
    return _planted_world(tmp_path_factory.mktemp("torch_cli_index_wide"),
                          104, 20000)


def _host_winnower_for_wide_windows(monkeypatch):
    """krepp_tpu's device winnower unrolls w - k passes into one program,
    which at w = 4200 does not compile in a test's time on the CPU: the
    reference directory of that case is built through its host path
    (minimizer.extract_genome_mers), which krepp_tpu's own tests hold equal
    to its device path."""
    from krepp_tpu.core import minimizer as jminimizer
    from krepp_tpu.core import winnow_device as jwd

    monkeypatch.setattr(jwd, "extract_genome_mers_device",
                        jminimizer.extract_genome_mers)


@pytest.mark.parametrize("flags,names", [
    (["--mesh", "2"], "world"),
    (["--sdust-t", "20", "--sdust-w", "64"], "long_world"),
    (["-w", "4200"], "wide_world"),
], ids=["flags0-slice 7", "flags1-item 12", "flags2-item 12"])
def test_index_options_not_ported_raise_naming_their_item(
        request, monkeypatch, tmp_path, flags, names):
    """The three options that used to raise NotImplementedError (the ids
    name the ROADMAP entries they waited for): each now builds, on the
    host's torch device, the directory krepp_tpu's `index` writes."""
    d = request.getfixturevalue(names)
    if "-w" in flags:
        _host_winnower_for_wide_windows(monkeypatch)
    argv = _index_argv(d, tmp_path / "want", ["-t"]) + flags
    assert jcli.main(argv) == 0
    argv = _index_argv(d, tmp_path / "x", ["-t"]) + flags
    assert cli.main(argv + ["--device", "cpu"]) == 0
    _assert_same_directory(tmp_path / "want", tmp_path / "x")
    assert artifact.load_index(str(tmp_path / "x")).nkmers > (
        5 if "-w" in flags else 500)


@pytest.mark.parametrize("case", ["mesh4", "device_winnower",
                                  "device_winnower_threads",
                                  "device_winnower_reference_format",
                                  "sdust_partial_no_frac"])
def test_index_device_paths_write_the_reference_directory(
        world, long_world, monkeypatch, tmp_path, case):
    """`index --mesh 4`, `index` with KREPP_DEVICE_WINNOW=1 (the variable
    krepp_tpu reads) and sdust with other options, through both CLIs."""
    d, flags, root = {
        "mesh4": (world, ["-t", "--mesh", "4"], ()),
        "device_winnower": (world, ["-t"], ()),
        "device_winnower_threads": (long_world, [], ("--num-threads", "3")),
        "device_winnower_reference_format": (
            long_world, ["-t", "--export-reference-format"], ("--seed", "9")),
        "sdust_partial_no_frac": (
            long_world, ["-t", "--sdust-t", "20", "--sdust-w", "64",
                         "--partial", "--no-frac", "-r", "0"], ()),
    }[case]
    if case.startswith("device_winnower"):
        monkeypatch.setenv("KREPP_DEVICE_WINNOW", "1")
    else:
        monkeypatch.delenv("KREPP_DEVICE_WINNOW", raising=False)
    assert jcli.main(_index_argv(d, tmp_path / "want", flags, root)) == 0
    assert cli.main(_index_argv(d, tmp_path / "got", flags, root)
                    + ["--device", "cpu"]) == 0
    _assert_same_directory(tmp_path / "want", tmp_path / "got")


def test_index_sdust_masks_kmers_of_the_planted_runs(long_world, tmp_path):
    for out, flags in (("plain", []), ("masked", ["--sdust-t", "20",
                                                  "--sdust-w", "64"])):
        assert cli.main(_index_argv(long_world, tmp_path / out, ["-t"])
                        + flags + ["--device", "cpu"]) == 0
    plain, masked = (artifact.load_index(str(tmp_path / o)).nkmers
                     for o in ("plain", "masked"))
    assert 0 < masked < plain


@pytest.mark.parametrize("case", ["sdust", "device_winnower",
                                  "sdust_over_device_winnower"])
def test_sketch_device_paths_write_the_reference_file(
        long_world, monkeypatch, tmp_path, case):
    """(A sketch file holds w in one byte, so a window wider than the C
    winnower's cannot be sketched by either package.)"""
    flags = [] if case == "device_winnower" else ["--sdust-t", "20",
                                                  "--sdust-w", "64"]
    monkeypatch.delenv("KREPP_DEVICE_WINNOW", raising=False)
    if case != "sdust":
        monkeypatch.setenv("KREPP_DEVICE_WINNOW", "1")
    argv = ["sketch", "-i", str(long_world / "G001.fna"), "-k", "26", *flags]
    assert jcli.main(argv + ["-o", str(tmp_path / "want.sk")]) == 0
    assert cli.main(argv + ["-o", str(tmp_path / "got.sk"),
                            "--device", "cpu"]) == 0
    assert filecmp.cmp(tmp_path / "want.sk", tmp_path / "got.sk",
                       shallow=False)
    assert artifact.load_sketch_reference(
        str(tmp_path / "got.sk")).nkmers > 200


def test_index_mesh_with_sdust_raises_naming_both_flags(long_world, tmp_path):
    """krepp_tpu's sharded build ignores the sdust flags and writes the
    unmasked index without a word; the port refuses the pair instead."""
    argv = _index_argv(long_world, tmp_path / "x", ["-t"]) + [
        "--mesh", "2", "--sdust-t", "20", "--sdust-w", "64", "--device", "cpu"]
    with pytest.raises(SystemExit, match=r"--mesh with --sdust-t/--sdust-w"):
        cli.main(argv)
    assert not os.path.exists(tmp_path / "x" / "meta.json")
    assert cli.main(argv[:argv.index("--sdust-t")] + ["--device", "cpu"]) == 0


def test_index_mesh_and_device_errors_name_what_is_missing(world, tmp_path,
                                                            monkeypatch,
                                                            capsys):
    """No path falls back: the device winnower and --mesh on the default
    device raise without a card, --mesh N names the count of cards, and
    so does the query commands' --mesh DATAxSHARD, which runs on the host
    with --device cpu and refuses a malformed spec."""
    monkeypatch.setenv("KREPP_DEVICE_WINNOW", "1")
    argv = _index_argv(world, tmp_path / "x", ["-t"])
    if not torch.cuda.is_available():
        for extra in ([], ["--mesh", "2"]):
            with pytest.raises(RuntimeError, match="is_available"):
                cli.main(argv + extra)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--mesh 2 asks for 2 CUDA devices "
                                           "but this machine has 1"):
        cli.main(argv + ["--mesh", "2"])
    assert not os.path.exists(tmp_path / "x" / "meta.json")
    monkeypatch.delenv("KREPP_DEVICE_WINNOW")
    assert cli.main(_index_argv(world, tmp_path / "idx", ["-t"])) == 0
    query = ["-q", str(world / "q.fq"), "-i", str(tmp_path / "idx")]
    for cmd in ("dist", "place"):
        with pytest.raises(RuntimeError, match="--mesh 1x2 asks for 2 CUDA "
                                               "devices but this machine "
                                               "has 1"):
            cli.main([cmd, *query, "--mesh", "1x2"])
        for spec in ("2x", "0x1"):
            with pytest.raises(SystemExit, match="DATAxSHARD"):
                cli.main([cmd, *query, "--mesh", spec, "--device", "cpu"])
        capsys.readouterr()
        outs = []
        for mesh in ([], ["--mesh", "1x2"]):
            assert cli.main([cmd, *query, *mesh, "--device", "cpu"]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and outs[0].count("\n") > 10


# ------------------------------------------------------------------ loading
def _keep(src, dst, pred):
    os.makedirs(dst)
    for name in os.listdir(src):
        if pred(name):
            shutil.copy(os.path.join(src, name), os.path.join(dst, name))


def _is_reference_file(name):
    return "-m4r" in name and not name.endswith((".json", ".npz"))


@pytest.fixture(scope="module")
def dirs(world, tmp_path_factory):
    """Every index form, written by the port's `index` command."""
    d = tmp_path_factory.mktemp("torch_cli_index_forms")
    assert cli.main(_index_argv(world, d / "frac", ["-t"])) == 0
    for r in ("0", "1"):
        assert cli.main(_index_argv(
            world, d / "both", ["-t", "--partial", "--no-frac", "-r", r,
                                "--export-reference-format"])) == 0
    assert cli.main(_index_argv(
        world, d / "single", ["-t", "--export-reference-format"])) == 0
    _keep(d / "both", d / "native_multi",
          lambda n: not _is_reference_file(n))
    _keep(d / "both", d / "reference_multi", _is_reference_file)
    _keep(d / "single", d / "reference_single", _is_reference_file)
    assert cli.main(_index_argv(
        world, d / "reference_no_tree",
        ["--export-reference-format"])) == 0
    for name in ("meta.json", "arrays.npz", "reflist.txt"):
        os.remove(d / "reference_no_tree" / name)
    return d


FORMS = ["native_multi", "reference_single", "reference_multi",
         "reference_no_tree"]


def _jload(path):
    return jcli._load_index(str(path))


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


def _assert_device_index_equal(want, got):
    for f in ("resident", "res_rank", "row_start", "enc_v", "se_v",
              "leaf_ses", "rho_slot", "se_mask", "row_ids", "leaf_csr_off",
              "leaf_csr_slots"):
        assert _same(getattr(want, f), getattr(got, f)), f
    for f in ("R", "nrows_u", "max_bucket", "wbackbone", "names",
              "slot_of_se", "info"):
        assert getattr(want, f) == getattr(got, f), f
    assert dataclasses.asdict(want.lsh) == dataclasses.asdict(got.lsh)
    for f in ("leaf_off", "leaf_list", "rho"):
        assert _same(getattr(want.colors, f), getattr(got.colors, f)), f
    assert (want.colors.nnodes, want.colors.nse) == \
        (got.colors.nnodes, got.colors.nse)
    assert want.res_info == got.res_info
    assert _same(getattr(want, "se_pse", None), getattr(got, "se_pse", None))
    assert want.tree.newick() == got.tree.newick()


@pytest.mark.parametrize("form", FORMS)
def test_load_index_matches_the_reference(dirs, form):
    want, got = _jload(dirs / form), artifact.load_index(str(dirs / form))
    _assert_device_index_equal(want, got)
    assert int(got.resident.sum()) == 2 and got.nkmers > 500
    assert (getattr(got, "se_pse", None) is not None) == \
        (form in ("reference_single", "reference_no_tree"))
    assert got.wbackbone == (form != "reference_no_tree")


@pytest.mark.parametrize("form", ["frac"] + FORMS)
def test_cli_inspect_and_dist_match_the_reference_cli(world, dirs, form,
                                                      capsys):
    idx, q = str(dirs / form), str(world / "q.fq")
    assert jcli.main(["inspect", "-i", idx]) == 0
    want = capsys.readouterr().out
    assert cli.main(["inspect", "-i", idx]) == 0
    got = capsys.readouterr().out
    assert got == want and got.count("======= Partial index:") == 2
    assert "\tOUTDEGREE_COUNT\t" in got
    assert jcli.main(["dist", "-q", q, "-i", idx]) == 0
    want = capsys.readouterr().out
    assert cli.main(["dist", "-q", q, "-i", idx, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) > 12


def _dist_rows(idx, q, capsys):
    capsys.readouterr()
    assert cli.main(["dist", "-q", q, "-i", str(idx), "--device", "cpu"]) == 0
    return capsys.readouterr().out.splitlines()[1:]


@pytest.mark.parametrize("form", ["native_multi", "reference_multi"])
def test_merged_partials_equal_the_frac_index(world, dirs, form, capsys):
    """-r 0 and -r 1 --no-frac partials combined at load answer as the one
    --frac -r 1 index does (ref workflow: src/krepp.cpp:66-108)."""
    di0 = artifact.load_index(str(dirs / "frac"))
    di = artifact.load_index(str(dirs / form))
    assert np.array_equal(di.resident, di0.resident)
    assert np.array_equal(di.enc_v, di0.enc_v)
    assert np.array_equal(di.row_start, di0.row_start)
    assert np.allclose(di.rho_slot, di0.rho_slot, rtol=0, atol=5e-9)
    leafsets = [[tuple(x.colors.leaves_of(int(se)).tolist())
                 for se in x.se_v] for x in (di0, di)]
    assert leafsets[0] == leafsets[1]
    q = str(world / "q.fq")
    assert _dist_rows(dirs / form, q, capsys) == \
        _dist_rows(dirs / "frac", q, capsys)


@pytest.mark.parametrize("reference_format", [False, True])
def test_partial_lsh_mismatch_rejected(world, tmp_path, reference_format):
    """Mixed-seed partials are refused with the reference's message
    (ref: src/lshf.cpp:159-180)."""
    flags = ["-t", "--partial", "--no-frac"]
    if reference_format:
        flags.append("--export-reference-format")
    for seed, r in (("2", "0"), ("99", "1")):
        assert cli.main(_index_argv(world, tmp_path / "bad", flags + ["-r", r],
                                    ("--seed", seed))) == 0
    if reference_format:
        for name in os.listdir(tmp_path / "bad"):
            if not _is_reference_file(name):
                os.remove(tmp_path / "bad" / name)
    for load in (_jload, lambda p: artifact.load_index(str(p))):
        with pytest.raises(ValueError, match="Partial libraries have "
                                             "incompatible hash functions!"):
            load(tmp_path / "bad")


def test_reference_loads_what_the_port_saves_and_back(world, dirs, tmp_path):
    """save_index_reference / save_native(partial=True) of one package and
    the loaders of the other, on a BuiltIndex loaded from disk."""
    built = artifact.load_native(str(dirs / "frac"))
    jbuilt = jartifact.load_native(str(dirs / "frac"))
    assert np.array_equal(artifact._decompose_colors(built),
                          jartifact._decompose_colors(jbuilt))
    artifact.save_index_reference(built, str(tmp_path / "t"), seed=3)
    jartifact.save_index_reference(jbuilt, str(tmp_path / "j"), seed=3)
    _assert_same_directory(tmp_path / "j", tmp_path / "t")
    _assert_device_index_equal(
        jartifact.load_index_reference(str(tmp_path / "t")),
        artifact.load_index_reference(str(tmp_path / "j")))
    out = io.StringIO()
    from krepp_tpu_torch.inspect import display_info
    display_info(artifact.load_index_reference(str(tmp_path / "t")), out)
    assert "seed: 3\n" in out.getvalue()
