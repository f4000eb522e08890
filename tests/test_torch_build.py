"""``repro_torch.kernels.build`` without a CUDA toolkit: a stand-in compiler
script shows that ``build_all`` runs every source, renames each library that
built into place, and leaves no temporary file behind when one fails."""
import os
import stat

import pytest

from repro_torch.kernels import build
from _torch_threads import _one_thread  # noqa: F401

FAKE_NVCC = """#!/bin/sh
# stand-in nvcc: writes the -o file, fails on any source named bad*.cu
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift 2 ;;
    *.cu) src="$1"; shift ;;
    *) shift ;;
  esac
done
echo "ptxas info : compiled $src"
echo library > "$out"
case "$(basename "$src")" in bad*) echo "error in $src"; exit 2 ;; esac
exit 0
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    return csrc, out


def test_build_all_builds_every_source_once(tree):
    csrc, out = tree
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    built = build.build_all()
    assert sorted(built) == ["a", "b"]
    assert all("ptxas" in text and secs >= 0
               for text, secs in built.values())
    assert sorted(os.listdir(out)) == sorted(
        build._target(n).name for n in ("a", "b"))
    assert build.build_all() == {}            # current libraries are reused


def test_build_all_failure_leaves_no_temporary_files(tree):
    csrc, out = tree
    for name in ("a", "bad", "c"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    with pytest.raises(build.KernelBuildError, match="bad.cu"):
        build.build_all()
    names = os.listdir(out)
    assert not [n for n in names if n.endswith(".tmp")]
    # the sources that compiled are in place; the failed one is not
    assert sorted(names) == sorted(build._target(n).name for n in ("a", "c"))
