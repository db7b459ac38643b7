"""The port's serving launcher for the AMG solver,
``python -m repro_torch.launch.serve --solver amg``, mirroring the reference
suite's ``tests/test_serve.py`` for the launcher's AMG side: the in-process
harness (direct and wire mode, the admission worker), the AMGWire socket
server behind ``--listen`` answering a client, the tenant specs, the
default tolerance, and the refusal to start on a machine without a card
unless ``--device cpu`` asks for the CPU.

The in-process runs go through ``main`` on ``--amg-backend torch --device
cpu``; the ``--listen`` run is a process of its own, stopped by SIGINT.
"""
import os
import pathlib
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.amg.api import clear_sessions, csr_to_wire  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serve import AMGWireClient  # noqa: E402
from repro_torch.serve.workload import (build_problems, default_tol,  # noqa: E402
                                        make_request, rel_residual)

ROOT = pathlib.Path(__file__).parents[1]
TORCH_CPU = ["--solver", "amg", "--amg-backend", "torch", "--device", "cpu",
             "--n-pods", "2", "--lanes", "4", "--n", "6"]


@pytest.fixture(autouse=True)
def _fresh_sessions():
    clear_sessions()
    yield
    clear_sessions()


def test_in_process_harness_on_the_torch_backend():
    stats = serve.main(TORCH_CPU + ["--dtype", "float64", "--requests", "8",
                                    "--batch", "4"])
    assert stats["requests"] == 8 and stats["errors"] == 0
    assert stats["unconverged"] == 0 and stats["setups"] == 2
    # drain(): each matrix's 4 requests in one chunk of max_rhs = 4 columns
    assert stats["batches"] == 2 and stats["batched_rhs"] == 8
    assert stats["worst_rel_residual"] <= 1e-8


def test_wire_mode_with_the_admission_worker():
    stats = serve.main(TORCH_CPU + ["--wire", "--coalesce-window", "0.1",
                                    "--requests", "6", "--method", "solve"])
    assert stats["wire_requests"] == 6 and stats["requests"] == 6
    assert stats["errors"] == 0
    # float32 by default: the torch backend's float32 tolerance
    assert stats["worst_rel_residual"] <= 100 * 1e-6


def test_host_backend_harness_matches_the_reference(capsys):
    """The same harness on ``--amg-backend host`` against the reference's
    launcher: the same requests, the same worst residual."""
    from repro.launch import serve as ref_serve

    argv = ["--solver", "amg", "--amg-backend", "host", "--n", "6",
            "--requests", "6"]
    ours = serve.main(argv)["worst_rel_residual"]
    capsys.readouterr()
    sys_argv = sys.argv
    try:
        sys.argv = ["serve"] + argv
        ref_serve.main()
    finally:
        sys.argv = sys_argv
    line = capsys.readouterr().out.splitlines()[0]
    theirs = float(re.search(r"worst rel residual (\S+)", line).group(1))
    assert f"{ours:.2e}" == f"{theirs:.2e}", (ours, line)


def test_listen_serves_a_client():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve"] + TORCH_CPU
        + ["--dtype", "float64", "--listen", "127.0.0.1:0",
           "--tenant", "alpha:8", "--tenant", "beta:2:1000000"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline()
        m = re.search(r"listening on (\S+):(\d+)", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None else "")
        problems = build_problems(6, count=1)
        mid, A = next(iter(problems.items()))
        rng = np.random.default_rng(0)
        with AMGWireClient.connect(m.group(1), int(m.group(2))) as c:
            assert c.ping()["tenants"] == ["alpha", "beta"]
            assert c.register("alpha", csr_to_wire(A))["matrix"] == mid
            b, payload = make_request(rng, problems, mid)
            x, diag = c.solve("alpha", payload, timeout=120)
            assert diag["converged"] and rel_residual(A, x, b) <= 1e-6
            st = c.stats()["tenants"]
            assert st["alpha"]["max_inflight"] == 8
            assert st["beta"]["max_inflight"] == 2
            assert st["alpha"]["completed"] == 1
    finally:
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err


def test_parse_tenant_spec():
    cfg = object()
    name, spec = serve.parse_tenant_spec("alpha:16:4096", cfg, max_rhs=3,
                                         coalesce_window=0.5)
    assert (name, spec.max_inflight, spec.max_matrix_bytes) == \
        ("alpha", 16, 4096)
    assert spec.config is cfg and spec.max_rhs == 3
    assert spec.coalesce_window == 0.5
    name, spec = serve.parse_tenant_spec("beta", cfg, max_rhs=8,
                                         coalesce_window=0.0)
    assert (name, spec.max_inflight, spec.max_matrix_bytes) == \
        ("beta", 32, None)
    for bad in (":4", "gamma:many"):
        with pytest.raises(SystemExit):
            serve.parse_tenant_spec(bad, cfg, max_rhs=8, coalesce_window=0.0)


def test_default_tol_by_backend_and_dtype():
    from repro.serve.workload import default_tol as ref_default_tol

    assert default_tol("host") == ref_default_tol("host") == 1e-8
    # float32 on the device: the reference's fp32 dist bar
    assert default_tol("torch") == ref_default_tol("dist") == 1e-6
    assert default_tol("torch", dtype="float64") == 1e-8
    assert default_tol("torch", 3e-5, "float64") == 3e-5


@pytest.mark.parametrize("extra", [[], ["--listen", "127.0.0.1:0"]],
                         ids=["harness", "listen"])
def test_amg_serving_refuses_without_a_card(monkeypatch, extra):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--solver", "amg"] + extra)
