"""The kernel libraries' cache key: a source's library path changes when
the source or any local header it includes changes, and only then. Needs
no nvcc: it only hashes files."""

import os

import pytest

from sdflabel_tpu_torch.ops import _cuda


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_cuda, "CSRC", str(tmp_path))
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "build"))
    files = {
        "k.cu": '#include <cuda_runtime.h>\n#include "a.cuh"\nint f();\n',
        "a.cuh": '#pragma once\n  # include "sub/b.cuh"\n',
        "sub/b.cuh": "#pragma once\nint b();\n",
        "other.cuh": "int unused();\n",
    }
    for name, text in files.items():
        os.makedirs(os.path.dirname(tmp_path / name), exist_ok=True)
        (tmp_path / name).write_text(text)
    return tmp_path


@pytest.mark.parametrize("edited,rebuilds", [
    ("k.cu", True), ("a.cuh", True), ("sub/b.cuh", True),
    ("other.cuh", False)])
def test_library_path_follows_included_headers(csrc, edited, rebuilds):
    before = _cuda.library_path("k")
    assert before == _cuda.library_path("k")  # stable
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    after = _cuda.library_path("k")
    assert (after != before) == rebuilds
    assert os.path.dirname(after) == str(csrc / "build")


def test_include_cycle_and_missing_header(csrc):
    (csrc / "a.cuh").write_text('#include "k.cu"\n#include "nowhere.cuh"\n')
    files = _cuda._source_files(str(csrc / "k.cu"), [])
    assert [os.path.basename(f) for f in files] == ["k.cu", "a.cuh"]


def test_every_source_hashes_its_headers():
    # the shared wgmma header is part of both MLP libraries' keys
    for name in ("select_mlp", "stage2_mlp"):
        files = _cuda._source_files(os.path.join(_cuda.CSRC, name + ".cu"),
                                    [])
        assert {os.path.basename(f) for f in files} >= {
            name + ".cu", "mlp_wgmma.cuh", "wgmma.cuh"}
