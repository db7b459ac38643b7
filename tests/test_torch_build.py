"""The kernel build's report of ``nvcc -Xptxas -v`` (registers, stack and
spills of every kernel instance), parsed on the CPU from a log of the form
the compiler writes; where the toolkit is missing, names stay mangled."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z5firstPKf' for 'sm_90a'
ptxas info    : Function properties for _Z5firstPKf
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z6secondPKd' for 'sm_90a'
ptxas info    : Function properties for _Z6secondPKd
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
"""


def _no_toolkit():
    raise RuntimeError("nvcc not found")


def test_ptxas_report_lists_every_instance(monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", _no_toolkit)
    rows = build.ptxas_report(LOG)
    assert [name for name, _ in rows] == ["_Z5firstPKf", "_Z6secondPKd"]
    assert rows[0][1] == ("Used 80 registers, used 1 barriers, 8 bytes cumulative "
                          "stack size; 8 bytes stack frame, 8 bytes spill stores, "
                          "8 bytes spill loads")
    assert rows[1][1].startswith("Used 40 registers") and "0 bytes spill" in rows[1][1]
    assert build.ptxas_report("nvcc: no kernels\n") == []


def test_build_report_reads_the_log_beside_the_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(tmp_path / "nvcc"))
    build.library_path("ell_spmm").with_suffix(".log").write_text(LOG)
    assert [n for n, _ in build.build_report("ell_spmm")] == ["_Z5firstPKf",
                                                             "_Z6secondPKd"]


def test_library_name_hashes_the_headers_beside_a_source(tmp_path, monkeypatch):
    """A kernel's library is rebuilt when a header its source may include
    (a ``*.cuh`` beside it) changes, and not for a file of another kind;
    the sparse kernels' sources include their value-type header."""
    for name in ("ell_spmv", "ell_spmm", "bcsr_spmm"):
        assert '#include "value_types.cuh"' in build.source_path(name).read_text()
    csrc = tmp_path / "spmv" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "ell_spmv.cu").write_text('#include "value_types.cuh"\n')
    (csrc / "value_types.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "KERNELS_DIR", tmp_path)
    first = build.library_path("ell_spmv")
    (csrc / "notes.txt").write_text("not a header\n")
    assert build.library_path("ell_spmv") == first
    (csrc / "value_types.cuh").write_text("// two\n")
    assert build.library_path("ell_spmv") != first


def test_shared_headers_are_hashed_and_on_the_include_path(tmp_path,
                                                           monkeypatch):
    """``value_types.cuh`` lives in the package's shared ``csrc/`` and every
    kernel with a bfloat16 instance includes it (the sparse kernels and both
    block smoothers); an edit there renames every library that may include
    it, and each ``nvcc`` is given that directory to search."""
    assert (build.shared_headers() / "value_types.cuh").exists()
    for name in ("ell_spmv", "ell_spmm", "bcsr_spmm", "block_diag_apply",
                 "tri_solve"):
        src = build.source_path(name)
        assert '#include "value_types.cuh"' in src.read_text()
        assert not (src.parent / "value_types.cuh").exists()
    csrc = tmp_path / "smoother" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "tri_solve.cu").write_text('#include "value_types.cuh"\n')
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "value_types.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "KERNELS_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    first = build.library_path("tri_solve")
    (tmp_path / "csrc" / "value_types.cuh").write_text("// two\n")
    assert build.library_path("tri_solve") != first

    seen = []

    class Done:
        returncode = 1

        def __init__(self, cmd, **kw):
            seen.append(cmd)

        def communicate(self):
            return "stopped before compiling", None

    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", Done)
    with pytest.raises(RuntimeError, match="stopped before compiling"):
        build.build(["tri_solve"])
    cmd = seen[0]
    assert cmd[cmd.index("-I") + 1] == str(tmp_path / "csrc")
