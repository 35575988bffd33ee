"""The port's batch reader (io/native_batch.py, csrc/fastx_batch.c) against
krepp_tpu's record reader and batcher: the port's QueryBatcher +
pad_codes_batch give krepp_tpu's names, batch boundaries, padded codes and
lengths on FASTA and FASTQ, gzipped and plain, wrapped, with CRLF, empty
lines, odd names, any base, lengths across the pad steps, a record longer
than the reader's first buffer and every batch edge; the errors match; and
`dist` and `seek` write krepp_tpu's rows on a gzipped FASTQ of mixed
lengths."""

import gzip
import io

import numpy as np
import pytest
import torch

from krepp_tpu.core import codec as jcodec
from krepp_tpu.index import artifact as jartifact
from krepp_tpu.index.build import build_index as jbuild_index
from krepp_tpu.index.build import build_sketch as jbuild_sketch
from krepp_tpu.index.index import DeviceIndex as JDeviceIndex
from krepp_tpu.io import fastx as jfastx
from krepp_tpu.params import IndexParams as JIndexParams
from krepp_tpu.params import LSHParams as JLSHParams
from krepp_tpu.query.dist import DistConfig as JDistConfig
from krepp_tpu.query.dist import _bucket_len as jbucket_len
from krepp_tpu.query.dist import run_dist as jrun_dist
from krepp_tpu.query.seek import run_seek as jrun_seek
from krepp_tpu.tree.newick import Tree as JTree
from krepp_tpu_torch.core.codec import pad_codes_batch
from krepp_tpu_torch.index.build import build_index
from krepp_tpu_torch.index.index import DeviceIndex, DeviceSketch
from krepp_tpu_torch.io import fastx
from krepp_tpu_torch.io.native_batch import ReadCodes
from krepp_tpu_torch.params import IndexParams, LSHParams
from krepp_tpu_torch.query.dist import DistConfig, _bucket_len, run_dist
from krepp_tpu_torch.query.seek import run_seek
from krepp_tpu_torch.tree.newick import Tree

import worldgen
from refcsrc import private_reference_csrc  # noqa: F401

torch.set_num_threads(1)

_RNG = np.random.default_rng(20)


def _seq(n, alphabet="ACGT"):
    letters = np.frombuffer(alphabet.encode(), np.uint8)
    return letters[_RNG.integers(0, len(letters), n)].tobytes().decode()


def _fq(name, seq, wrap=0):
    """A FASTQ record; wrap > 0 splits the sequence and quality lines."""
    qual = _seq(len(seq), "@+I#5")
    if wrap:
        seq = "\n".join(seq[i: i + wrap] for i in range(0, len(seq), wrap))
        qual = "\n".join(qual[i: i + wrap] for i in range(0, len(qual), wrap))
    return f"@{name}\n{seq}\n+\n{qual}\n"


def _fa(name, seq, wrap=0):
    if wrap:
        seq = "\n".join(seq[i: i + wrap] for i in range(0, len(seq), wrap))
    return f">{name}\n{seq}\n"


def _reads(n, lo=60, hi=300):
    return [(f"r{i}", _seq(int(_RNG.integers(lo, hi)))) for i in range(n)]


_MIXED = _reads(90)
_EXACT = [(f"e{i}", _seq(100)) for i in range(12)]
# (text, gzip, bp_limit)
CASES = {
    "fasta": ("".join(_fa(n, s) for n, s in _MIXED), False, 2000),
    "fasta_gz": ("".join(_fa(n, s) for n, s in _MIXED), True, 2000),
    "fastq": ("".join(_fq(n, s) for n, s in _MIXED), False, 2000),
    "fastq_gz": ("".join(_fq(n, s) for n, s in _MIXED), True, 2000),
    "fastq_wrapped": ("".join(_fq(n, s, wrap=37) for n, s in _MIXED),
                      False, 1500),
    "fasta_multiline": ("".join(_fa(n, s, wrap=60) for n, s in _MIXED),
                        True, 1500),
    "crlf_and_empty_lines": (
        "\n\n" + "\n\n".join(_fq(n, s, wrap=40).replace("\n", "\r\n")
                             for n, s in _MIXED[:30]) + "\r\n\n",
        False, 900),
    "crlf_fasta_empty_lines": (
        "".join(_fa(n, s, wrap=50).replace("\n", "\r\n") + "\n\r\n"
                for n, s in _MIXED[:30]), True, 900),
    "names": ("".join(_fq(n, _seq(80)) for n in (
        "a b c", "tab\there", "réad_ü中 x", "n" * 300,
        "é" * 127 + "xy", "", " lead", "cr\rin")), False, 200),
    "lowercase_and_n": ("".join(_fa(n, _seq(150, "ACGTacgtNnRYK-.*"))
                                for n in "abcdefgh"), False, 400),
    "bucket_steps": ("".join(_fq(f"L{n}_{i}", _seq(n))
                             for i, n in enumerate((64, 65, 512, 513, 64,
                                                    513, 65, 1, 1000)))
                     , False, 600),
    "longer_than_the_first_buffer": (
        _fa("long", _seq(1_300_000)) + _fa("short", _seq(70))
        + _fa("wrapped_long", _seq(1_100_000), wrap=700_000), True, 1 << 30),
    "fastq_longer_than_the_first_buffer": (
        _fq("long", _seq(1_200_000)) + _fq("s", _seq(90)), False, 1 << 20),
    "bp_limit_1": ("".join(_fq(n, s) for n, s in _MIXED[:25]), False, 1),
    "ends_exactly_at_bp_limit": ("".join(_fq(n, s) for n, s in _EXACT),
                                 True, 400),
    "one_record": (_fq("only", _seq(150)), False, 16384 * 150),
    "one_record_fasta": (_fa("only", _seq(150)), True, 1),
    "empty_records": (">a\n>b\nACGT\n>c\n\n>d\nAC\n", False, 3),
    "garbage_after_records": (_fq("a", _seq(70)) + _fq("b", _seq(80))
                              + "\nnot a header\n" + _fq("c", _seq(90)),
                              False, 100),
    "fastq_without_quality_at_the_end": (_fq("a", _seq(70)) + "@b\nACGTN",
                                         False, 10),
}


def _write(path, text, gz):
    data = text.encode()
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_match_the_reference(tmp_path, case):
    """Names, batch boundaries, each read's codes, and the padded [B, L]
    codes and lengths (at the query drivers' width and at the default)."""
    text, gz, bp_limit = CASES[case]
    path = tmp_path / ("q.fq" + (".gz" if gz else ""))
    _write(path, text, gz)
    path = str(path)
    want = list(jfastx.QueryBatcher(path, bp_limit=bp_limit))
    got = list(fastx.QueryBatcher(path, bp_limit=bp_limit))
    assert len(got) == len(want) > 0
    if case == "bp_limit_1":
        assert len(got) == 25
    if case == "ends_exactly_at_bp_limit":
        assert [len(n) for n, _ in got] == [4, 4, 4]
    for (jn, js), (tn, ts) in zip(want, got):
        assert tn == jn and isinstance(tn, list)
        assert isinstance(ts, ReadCodes) and len(ts) == len(js)
        for a, b in zip(js, ts):
            assert b.dtype == a.dtype and np.array_equal(a, b)
        width = jbucket_len(max(len(s) for s in js))
        assert _bucket_len(int(ts.lengths.max())) == width
        for pad_to in (width, None):
            jc, jl = jcodec.pad_codes_batch(js, pad_to=pad_to)
            # the batch form, and the list form as before
            for form in (ts, list(ts)):
                tc, tl = pad_codes_batch(form, pad_to=pad_to)
                assert tc.dtype == jc.dtype and np.array_equal(tc, jc)
                assert tl.dtype == jl.dtype and np.array_equal(tl, jl)


def test_pad_codes_batch_refuses_a_row_too_narrow(tmp_path):
    """A read longer than pad_to raises ValueError, in either form."""
    path = tmp_path / "q.fa"
    _write(path, _fa("a", _seq(70)) + _fa("b", _seq(90)), False)
    (_, reads), = fastx.QueryBatcher(str(path), bp_limit=1 << 20)
    for form in (reads, list(reads)):
        with pytest.raises(ValueError):
            pad_codes_batch(form, pad_to=80)


@pytest.mark.parametrize("case", ["empty", "only_empty_lines",
                                  "not_a_sequence_file", "missing"])
def test_batcher_errors_match_the_reference(tmp_path, case):
    """An empty file yields nothing, a file that starts with anything but
    '>' or '@' raises ValueError, a missing one FileNotFoundError."""
    path = tmp_path / "q.fq"
    if case == "empty":
        path.write_bytes(b"")
    elif case == "only_empty_lines":
        path.write_bytes(b"\n\r\n\n")
    elif case == "not_a_sequence_file":
        path.write_bytes(b"\nnot a sequence file\n@r\nACGT\n+\nIIII\n")
    results = []
    for batcher in (jfastx.QueryBatcher, fastx.QueryBatcher):
        try:
            results.append(list(batcher(str(path), bp_limit=100)))
        except (ValueError, FileNotFoundError) as e:
            results.append(type(e))
    want = {"empty": [], "only_empty_lines": [],
            "not_a_sequence_file": ValueError,
            "missing": FileNotFoundError}[case]
    assert results == [want, want]


# -------------------------------------------- dist and seek, byte for byte
@pytest.fixture(scope="module")
def mixed_world(tmp_path_factory):
    """A 6-leaf world built by each package, a gzipped FASTQ of reads of
    mixed lengths (60-700 bp, across the pad steps), and both packages'
    sketches of one genome."""
    rng = np.random.default_rng(21)
    d = tmp_path_factory.mktemp("torch_read_batches")
    nwk, genomes = worldgen.make_world(rng, nleaves=6, glen=2000, rate=0.05)
    input_map = []
    for name in sorted(genomes):
        p = d / f"{name}.fna"
        with open(p, "w") as f:
            for i, contig in enumerate(genomes[name]):
                f.write(f">{name}_c{i}\n{contig}\n")
        input_map.append((name, str(p)))
    jdi = JDeviceIndex.from_built(jbuild_index(
        input_map, JIndexParams(lsh=JLSHParams.generate(27, 11, 2, seed=3),
                                w=35, r=1, frac=True),
        JTree.parse(nwk), progress=False))
    params = IndexParams(lsh=LSHParams.generate(27, 11, 2, seed=3), w=35,
                         r=1, frac=True)
    tdi = DeviceIndex.from_built(build_index(input_map, params,
                                             Tree.parse(nwk), progress=False))
    text = []
    for rlen in (60, 64, 65, 150, 150, 300, 512, 513, 700):
        for rid, seq in worldgen.sample_reads(rng, genomes, n=3, rlen=rlen,
                                              mut=0.04, with_n=1,
                                              with_garbage=1):
            text.append(f"@{rid}_{rlen} x\n{seq}\n+\n{'I' * len(seq)}\n")
    order = rng.permutation(len(text))
    qpath = d / "q.fq.gz"
    with gzip.open(qpath, "wt") as f:
        f.write("".join(text[i] for i in order))
    sk_params = JIndexParams(lsh=JLSHParams.generate(26, 10, 2, seed=4),
                             w=32, r=1, frac=True)
    jartifact.save_sketch_reference(
        jbuild_sketch(input_map[0][1], sk_params, progress=False),
        str(d / "g.sk"))
    sk = jartifact.load_sketch_reference(str(d / "g.sk"))
    return jdi, tdi, sk, str(qpath), len(text)


@pytest.mark.parametrize("batch_bp", [1200, 16384 * 150])
def test_dist_rows_on_a_gzipped_fastq_of_mixed_lengths(mixed_world,
                                                       batch_bp):
    jdi, tdi, _, qpath, nreads = mixed_world
    want, got = io.StringIO(), io.StringIO()
    jrun_dist(jdi, qpath, want, "inv", JDistConfig(batch_bp=batch_bp))
    stats = {}
    assert run_dist(tdi, qpath, got, "inv", DistConfig(batch_bp=batch_bp),
                    device="cpu", stats=stats) == nreads
    assert got.getvalue() == want.getvalue()
    assert len(got.getvalue().splitlines()) > nreads
    assert (stats["batches"] > 4) == (batch_bp == 1200)


def test_seek_rows_on_a_gzipped_fastq_of_mixed_lengths(mixed_world):
    _, _, sk, qpath, nreads = mixed_world
    want, got = io.StringIO(), io.StringIO()
    assert jrun_seek(sk, qpath, want, "inv") == nreads
    assert run_seek(DeviceSketch.from_reference(sk), qpath, got, "inv",
                    device="cpu") == nreads
    text = got.getvalue()
    assert text == want.getvalue()
    assert len(text.splitlines()) == 2 + nreads and "\tNaN\n" in text
    assert any(not ln.endswith("NaN") for ln in text.splitlines()[2:])
