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
