"""Port `inspect` vs krepp_tpu's: the same text on a native index, through
the functions and both CLIs; a reference-format directory prints the
reference's text too, and a broken one is refused as the reference does."""

import io
import os
import subprocess
import sys

import pytest

from krepp_tpu.index import artifact as jartifact
from krepp_tpu.inspect import display_info as jdisplay_info
from krepp_tpu_torch import cli
from krepp_tpu_torch.index import artifact
from krepp_tpu_torch.inspect import display_info
from krepp_tpu_torch.testing import build_world_index
from refcsrc import private_reference_csrc  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    """A 12-leaf world at m = 4 (two resident residues, so two partial
    blocks), saved as a native index."""
    d = tmp_path_factory.mktemp("torch_inspect")
    built, _, _ = build_world_index(seed=3, nleaves=12, glen=3000, m=4)
    artifact.save_native(built, str(d / "idx"))
    return d


def test_inspect_text_matches_reference(index_dir):
    idx = str(index_dir / "idx")
    want, got = io.StringIO(), io.StringIO()
    jdisplay_info(jartifact.load_native_device(idx), want)
    display_info(artifact.load_index(idx), got)
    assert got.getvalue() == want.getvalue()
    text = got.getvalue()
    assert text.startswith("Backbone tree: (")
    assert text.count("======= Partial index:") == 2
    assert "\tOUTDEGREE_COUNT\t" in text and "\tMER_COUNT\t" in text


def test_cli_inspect_matches_the_reference_cli(index_dir, capsys):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    want = subprocess.run([sys.executable, "-m", "krepp_tpu", "inspect",
                           "-i", "idx"], cwd=index_dir, env=env,
                          capture_output=True, text=True, timeout=300)
    assert want.returncode == 0, want.stderr
    assert cli.main(["inspect", "-i", str(index_dir / "idx")]) == 0
    got = capsys.readouterr().out
    assert got == want.stdout and len(got.splitlines()) > 10


def test_cli_inspect_refuses_a_reference_format_index(tmp_path, capsys):
    """Only a broken reference-format directory is refused, with the
    reference's text; a whole one prints the binary color graph's
    OUTDEGREE histogram as krepp_tpu does."""
    (tmp_path / "cmer-m4r1-frac").write_bytes(b"")
    with pytest.raises(ValueError, match="partial index with a missing file"):
        cli.main(["inspect", "-i", str(tmp_path)])
    built, _, _ = build_world_index(seed=3, nleaves=12, glen=3000, m=4)
    ref = str(tmp_path / "ref")
    artifact.save_index_reference(built, ref, seed=0)
    capsys.readouterr()
    assert cli.main(["inspect", "-i", ref]) == 0
    got = capsys.readouterr().out
    want = io.StringIO()
    jdi = jartifact.load_index_reference(ref)
    assert jdi.se_pse is not None
    jdisplay_info(jdi, want)
    assert got == want.getvalue()
    assert got.count("======= Partial index:") == 2 and "seed: 0\n" in got
