"""URL inputs: sequence paths given as http:// URLs, served by a loopback
server on 127.0.0.1 from a directory of this test, through the port and
through krepp_tpu. The readers, `index` (--num-threads 2 and --mesh 2),
`dist`, `place`, `sketch` and `seek` give from a URL what they give from
the local file and what krepp_tpu gives from the same URL; the port removes
every download (after the read, after an error in it, after an early
close), and a failed download raises naming the URL. krepp_tpu leaves its
downloads in the temporary directory, so its runs get a directory of their
own. CPU only; nothing leaves the machine."""

import contextlib
import functools
import gzip
import http.server
import os
import socket
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

from krepp_tpu import cli as jcli
from krepp_tpu.io import fastx as jfastx
from krepp_tpu_torch import cli
from krepp_tpu_torch.io import fastx

import worldgen
from test_e2e_dist import write_world
from test_torch_cli_index import LSH, _assert_same_directory
from refcsrc import private_reference_csrc  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = ("--seed", "7")


def _fastq(reads) -> str:
    return "".join(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n"
                   for rid, seq in reads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Six genomes of 1.4 kbp as FASTA files (every other one also
    gzipped), a two-contig file, the tree, 12 reads as FASTQ and FASTA
    (plain and gzipped), FASTQ text under a .gz name, a malformed file, and
    name->path maps of the local files and of their URLs (the gzipped
    copies where there are any); {URL} stands for the server's root."""
    rng = np.random.default_rng(211)
    d = tmp_path_factory.mktemp("torch_url")
    nwk, genomes = worldgen.make_world(rng, nleaves=6, glen=1400, rate=0.05)
    local, urls = [], []
    for i, (name, path) in enumerate(write_world(d, genomes)):
        local.append(f"{name}\t{path}\n")
        served = os.path.basename(path)
        if i % 2:
            served += ".gz"
            with open(path, "rb") as f, gzip.open(d / served, "wb") as g:
                g.write(f.read())
        urls.append(f"{name}\t{{URL}}/{served}\n")
    (d / "map.tsv").write_text("".join(local))
    (d / "map_url.tsv").write_text("".join(urls))
    (d / "tree.nwk").write_text(nwk + "\n")
    names = sorted(genomes)
    (d / "two.fna").write_text("".join(
        f">{n}\n{genomes[n][0]}\n" for n in names[:2]))
    reads = worldgen.sample_reads(rng, genomes, n=12, mut=0.05)
    (d / "q.fq").write_text(_fastq(reads))
    (d / "plain_body.fq.gz").write_text(_fastq(reads))
    (d / "q.fa").write_text("".join(f">{rid}\n{seq}\n" for rid, seq in reads))
    for name in ("q.fq", "q.fa"):
        with gzip.open(d / (name + ".gz"), "wt") as g:
            g.write((d / name).read_text())
    (d / "bad.fq").write_text("not a sequence file\n")
    return d


class _Handler(http.server.SimpleHTTPRequestHandler):
    def do_GET(self):
        self.server.gets.append(self.path)
        super().do_GET()

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def server(world):
    """(root URL, list of the paths requested) of a server of `world` on
    127.0.0.1, shut down at the end of the module."""
    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(_Handler, directory=str(world)))
    httpd.gets = []
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    root = f"http://127.0.0.1:{httpd.server_address[1]}"
    with pytest.MonkeyPatch.context() as mp:
        # a proxy of the environment must not see loopback requests
        for var in ("no_proxy", "NO_PROXY"):
            mp.setenv(var, "127.0.0.1")
        yield root, httpd.gets
    httpd.shutdown()
    httpd.server_close()
    thread.join()


@contextlib.contextmanager
def downloads_into(d):
    """tempfile's directory is `d` for the block (both packages download
    through tempfile)."""
    os.makedirs(d, exist_ok=True)
    saved = tempfile.tempdir
    tempfile.tempdir = str(d)
    try:
        yield str(d)
    finally:
        tempfile.tempdir = saved


def _downloads(d):
    return sorted(n for n in os.listdir(d) if n.startswith("seq_"))


@pytest.fixture
def port_tmp(tmp_path):
    """The port's temporary directory for the test."""
    with downloads_into(tmp_path / "port_tmp") as d:
        yield d


def reference(tmp_path):
    """A fresh temporary directory for a krepp_tpu run, which leaves its
    downloads there."""
    return downloads_into(tempfile.mkdtemp(prefix="ref_", dir=tmp_path))


@pytest.fixture(scope="module")
def url_map(world, server, tmp_path_factory):
    path = tmp_path_factory.mktemp("url_map") / "map_url.tsv"
    path.write_text((world / "map_url.tsv").read_text()
                    .replace("{URL}", server[0]))
    return str(path)


def _index_argv(world, map_path, out, root=ROOT, extra=()):
    return [*root, "index", "-i", map_path, "-o", str(out), "-t",
            str(world / "tree.nwk"), *LSH, *extra]


@pytest.fixture(scope="module")
def idx(world):
    """The port's index of the local files."""
    out = world / "idx_local"
    if not out.exists():
        assert cli.main(_index_argv(world, str(world / "map.tsv"), out)) == 0
    return out


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("path,want", [
    ("http://127.0.0.1:8000/q.fq", True),
    ("https://host/genomes/G000.fna.gz", True),
    ("ftp://host/genomes/all/GCF_000005845.2_genomic.fna.gz", True),
    ("file:///data/q.fq", False),
    ("HTTP://host/q.fq", False),
    ("http://", False),
    ("http://host/q.fq ", False),
    ("http://host/a b.fq", False),
    ("refs/G000.fna", False),
    ("/data/http://q.fq", False),
])
def test_is_url_matches_the_reference(path, want):
    assert fastx.is_url(path) == jfastx.is_url(path) == want


# ------------------------------------------------------------------ (b)
READ_FILES = ["G000.fna", "G001.fna.gz", "two.fna", "q.fq", "q.fq.gz",
              "q.fa", "q.fa.gz", "plain_body.fq.gz"]
# the local file of each served copy that is not itself local
LOCAL_OF = {"G001.fna.gz": "G001.fna", "q.fq.gz": "q.fq", "q.fa.gz": "q.fa",
            "plain_body.fq.gz": "q.fq"}


def _codes(recs):
    return [np.asarray(c).tolist() for c in recs]


def _batches(batcher):
    return [(names, _codes(seqs)) for names, seqs in batcher]


@pytest.mark.parametrize("name", READ_FILES)
def test_readers_from_a_url_match_the_local_file_and_the_reference(
        world, server, port_tmp, tmp_path, name):
    """read_genome_codes and QueryBatcher (small batches) from the URL:
    the local file's records (the plain file for a gzipped copy) and
    krepp_tpu's from the same URL; one request an iteration."""
    url = f"{server[0]}/{name}"
    local = str(world / LOCAL_OF.get(name, name))
    gets = len(server[1])
    got = _codes(fastx.read_genome_codes(url))
    want = _codes(fastx.read_genome_codes(local))
    got_b = _batches(fastx.QueryBatcher(url, bp_limit=500))
    assert len(server[1]) == gets + 2
    assert _downloads(port_tmp) == []
    with reference(tmp_path):
        ref = _codes(jfastx.read_genome_codes(url))
        ref_b = _batches(jfastx.QueryBatcher(url, bp_limit=500))
    assert got == want == ref and got
    assert got_b == _batches(fastx.QueryBatcher(local, bp_limit=500)) == ref_b
    assert len(got_b) >= 2 or ".fna" in name


# ------------------------------------------------------------------ (c)
@pytest.fixture(scope="module")
def reference_url_index(world, url_map, tmp_path_factory):
    d = tmp_path_factory.mktemp("reference_url_index")
    with reference(d):
        assert jcli.main(_index_argv(world, url_map, d / "idx")) == 0
    return d / "idx"


@pytest.mark.parametrize("root,extra", [
    ((*ROOT, "--num-threads", "2"), ()),
    (ROOT, ("--mesh", "2", "--device", "cpu")),
], ids=["num_threads_2", "mesh_2"])
def test_index_from_urls_writes_the_local_directory(
        world, server, url_map, idx, reference_url_index, port_tmp, tmp_path,
        root, extra):
    """`index -i` a map of URLs (half of them gzipped copies): the
    directory of the local files, and krepp_tpu's from the same URLs; one
    request a genome."""
    gets = len(server[1])
    out = tmp_path / "idx_url"
    assert cli.main(_index_argv(world, url_map, out, root, extra)) == 0
    assert len(server[1]) == gets + 6
    assert _downloads(port_tmp) == []
    _assert_same_directory(idx, out)
    _assert_same_directory(reference_url_index, out)


# ------------------------------------------------------------------ (d)
@pytest.mark.parametrize("argv,mesh,query", [
    (["dist"], [], "q.fq"),
    (["dist"], ["--mesh", "1x2"], "q.fa.gz"),
    (["place"], [], "q.fq.gz"),
    (["place", "--tabular"], [], "q.fq"),
], ids=["dist", "dist_mesh", "place", "place_tabular"])
def test_query_from_a_url_matches_the_local_run_and_the_reference(
        world, server, idx, port_tmp, tmp_path, argv, mesh, query):
    """`dist` / `place -q URL --device cpu` (dist also with --mesh 1x2):
    byte for byte the local run and krepp_tpu's one-device run on the same
    URL (in this process: the same sys.argv, so the same invocation
    line)."""
    url = f"{server[0]}/{query}"
    local = str(world / query.removesuffix(".gz"))
    common = ["-i", str(idx)]
    outs = {}
    gets = len(server[1])
    for tag, q in (("url", url), ("local", local)):
        outs[tag] = tmp_path / tag
        assert cli.main([*argv, "-q", q, *common, "-o", str(outs[tag]),
                         *mesh, "--device", "cpu"]) == 0
    assert len(server[1]) == gets + 1
    assert _downloads(port_tmp) == []
    outs["reference"] = tmp_path / "reference"
    with reference(tmp_path):
        assert jcli.main([*argv, "-q", url, *common, "-o",
                          str(outs["reference"])]) == 0
    text = outs["url"].read_bytes()
    assert text == outs["local"].read_bytes() == outs["reference"].read_bytes()
    assert len(text.splitlines()) > 8


def test_sketch_and_seek_from_a_url_match_the_local_run_and_the_reference(
        world, server, port_tmp, tmp_path):
    """`sketch -i URL` (a gzipped genome) writes the local file's sketch
    and krepp_tpu's from the URL, byte for byte; `seek -q URL --device cpu`
    the same rows as from the local reads and krepp_tpu's from the URL."""
    g_url, q_url = f"{server[0]}/G001.fna.gz", f"{server[0]}/q.fq.gz"
    sk = {t: str(tmp_path / f"{t}.sk") for t in ("url", "local", "ref")}
    rows = {t: str(tmp_path / f"{t}.tsv") for t in sk}
    gets = len(server[1])
    assert cli.main(["sketch", "-i", g_url, "-o", sk["url"]]) == 0
    assert cli.main(["sketch", "-i", str(world / "G001.fna"), "-o",
                     sk["local"]]) == 0
    for tag, q in (("url", q_url), ("local", str(world / "q.fq"))):
        assert cli.main(["seek", "-q", q, "-i", sk["local"], "-o", rows[tag],
                         "--device", "cpu"]) == 0
    assert len(server[1]) == gets + 2
    assert _downloads(port_tmp) == []
    with reference(tmp_path):
        assert jcli.main(["sketch", "-i", g_url, "-o", sk["ref"]]) == 0
        assert jcli.main(["seek", "-q", q_url, "-i", sk["ref"], "-o",
                          rows["ref"]]) == 0
    with open(sk["url"], "rb") as f:
        got = f.read()
    for t in ("local", "ref"):
        with open(sk[t], "rb") as f:
            assert f.read() == got
    with open(rows["url"]) as f:
        text = f.read()
    for t in ("local", "ref"):
        with open(rows[t]) as f:
            assert f.read() == text
    nreads = len((world / "q.fq").read_text().splitlines()) // 4
    found = [r for r in text.splitlines()[2:] if not r.endswith("\tNaN")]
    assert len(text.splitlines()) == 2 + nreads and found


# ------------------------------------------------------------------ (e)
def test_no_download_is_left_after_a_read_that_raises(world, server, idx,
                                                       port_tmp):
    """A malformed file served over HTTP: the reader raises, through the
    batcher, the genome reader and `dist`, and its download is gone."""
    url = f"{server[0]}/bad.fq"
    for read in (lambda: list(fastx.QueryBatcher(url)),
                 lambda: list(fastx.read_genome_codes(url)),
                 lambda: cli.main(["dist", "-q", url, "-i", str(idx),
                                   "--device", "cpu"])):
        with pytest.raises(ValueError, match="Unrecognised FASTA/FASTQ"):
            read()
        assert _downloads(port_tmp) == []


def test_no_download_is_left_after_an_early_close(world, server, port_tmp):
    """A batcher and a genome reader closed after their first item: the
    download exists while they read and is gone once they are closed."""
    for it in (iter(fastx.QueryBatcher(f"{server[0]}/q.fq.gz", bp_limit=1)),
               fastx.read_genome_codes(f"{server[0]}/two.fna")):
        next(it)
        assert len(_downloads(port_tmp)) == 1
        it.close()
        assert _downloads(port_tmp) == []


def test_reference_faults_the_port_avoids(world, server, port_tmp, tmp_path):
    """krepp_tpu's QueryBatcher downloads again on every iteration and
    leaves each download behind; the port's removes each one."""
    url = f"{server[0]}/q.fq"
    gets = len(server[1])
    with reference(tmp_path) as ref_tmp:
        batcher = jfastx.QueryBatcher(url)
        assert _batches(batcher) == _batches(batcher)
        assert len(_downloads(ref_tmp)) == 2
    batcher = fastx.QueryBatcher(url)
    assert _batches(batcher) == _batches(batcher)
    assert _downloads(port_tmp) == []
    assert len(server[1]) == gets + 4


# ------------------------------------------------------------------ (f)
def _refused_url():
    """A URL on a loopback port nothing listens on (refused at once)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return f"http://127.0.0.1:{port}/q.fq"


@pytest.mark.parametrize("kind", ["404", "refused"])
def test_a_failed_download_raises_naming_the_url(world, server, idx,
                                                 port_tmp, tmp_path, kind):
    """RuntimeError with krepp_tpu's text, from the readers and `dist` /
    `index`, and no file left; no fallback."""
    url = (f"{server[0]}/missing.fq" if kind == "404" else _refused_url())
    with reference(tmp_path) as ref_tmp:
        with pytest.raises(RuntimeError) as want:
            list(jfastx.QueryBatcher(url))
        assert _downloads(ref_tmp) == []
    lines = (world / "map.tsv").read_text().splitlines(keepends=True)
    bad_map = tmp_path / "map.tsv"
    bad_map.write_text("".join(lines[:-1]) + lines[-1].split("\t")[0]
                       + f"\t{url}\n")
    for read in (lambda: list(fastx.QueryBatcher(url)),
                 lambda: list(fastx.read_genome_codes(url)),
                 lambda: cli.main(["dist", "-q", url, "-i", str(idx),
                                   "--device", "cpu"]),
                 lambda: cli.main(_index_argv(world, str(bad_map),
                                              tmp_path / "idx"))):
        with pytest.raises(RuntimeError) as got:
            read()
        assert str(got.value) == str(want.value)
        assert str(got.value).startswith(f"Failed to download {url}: ")
        assert _downloads(port_tmp) == []


def test_the_cli_exits_non_zero_on_a_failed_download(world, server, idx,
                                                     tmp_path):
    """`python -m krepp_tpu_torch dist -q URL` of a missing file: a
    non-zero exit naming the URL, and no file left."""
    url = f"{server[0]}/missing.fq"
    (tmp_path / "tmp").mkdir()
    env = dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(tmp_path / "tmp"),
               no_proxy="127.0.0.1", NO_PROXY="127.0.0.1")
    out = tmp_path / "out.tsv"
    run = subprocess.run(
        [sys.executable, "-m", "krepp_tpu_torch", "dist", "-q", url, "-i",
         str(idx), "-o", str(out), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert f"RuntimeError: Failed to download {url}: HTTP Error 404" \
        in run.stderr
    assert _downloads(tmp_path / "tmp") == []
