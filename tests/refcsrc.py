"""Private builds of krepp_tpu's C libraries for the port's parity tests.

krepp_tpu's loaders (`core/native_colorize.py`, `core/native_sort.py`,
`core/native_extract.py`, `io/native.py`, `io/native_report.py`) compile
with `cc -o <final path>` into the repository's shared `csrc/`. Under
pytest-xdist's `--dist load` one worker can open a library that another is
still writing; the loader then marks itself failed for the life of that
worker (or, in `native_report`, raises from `ctypes.CDLL`), and every later
parity case there fails. The autouse fixture below points each loader at a
copy of `csrc/*.c` in a directory of this worker's own and clears its
state for the module's tests; the reference's loader, binding and
self-test run unchanged. A test module that calls krepp_tpu imports it:

    from refcsrc import private_reference_csrc  # noqa: F401
"""

import glob
import os
import shutil

import pytest

from krepp_tpu.core import native_colorize, native_extract, native_sort
from krepp_tpu.io import native, native_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOADERS = (native_colorize, native_extract, native_sort, native, native_report)
_DIR = []           # this worker's copy of csrc/, made once


def private_csrc(tmp_path_factory) -> str:
    """This worker's copy of the reference's C sources (made at first use;
    the libraries are built into it by the loaders, once per worker)."""
    if not _DIR:
        d = tmp_path_factory.mktemp("reference_csrc")
        for src in glob.glob(os.path.join(REPO, "csrc", "*.c")):
            shutil.copy(src, d)
        _DIR.append(str(d))
    return _DIR[0]


@pytest.fixture(scope="module", autouse=True)
def private_reference_csrc(tmp_path_factory):
    d = private_csrc(tmp_path_factory)
    with pytest.MonkeyPatch.context() as mp:
        for mod in LOADERS:
            mp.setattr(mod, "_csrc_dir", lambda: d)
            mp.setattr(mod, "_LIB", None)
            for flag in ("_FAILED", "_BUILD_FAILED"):
                if hasattr(mod, flag):
                    mp.setattr(mod, flag, False)
        yield d
