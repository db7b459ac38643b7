"""The port's static analysis (:mod:`repro_torch.analysis`), mirroring the
reference suite's ``tests/test_analysis.py``.

The audit: golden ``hier_psum`` / ``hier_all_gather`` logs at 1×1 and 2×4,
the halo tables against operators, a clean audit over the whole V/W/F ×
five-smoother grid on 2×4 (the reference's 15 pairs), the two injected regressions (a flat psum, a
collective on an empty-halo level), the poisoned-halo overlap check with a
serial counter-example, and a report round-trip.  The lint: each rule on bad
and sanctioned sources, and ``src/repro_torch`` clean.

Against the reference: for the same host hierarchy on 2×4, the port's count
model and its logged counts equal the reference's count model and its
jaxpr-walked counts, for every program × (cycle, smoother), and every apply's
logged signature equals the reference's traced one.  The JAX side needs 8
host devices before jax is imported, so it runs once per module as a
subprocess of this very file::

    python tests/test_torch_analysis.py --jax-ref OUT.json IN.npz

Under capture (a stand-in graph object plays the CUDA graph): the replayed
logs audit clean, and a replay whose recorded log lost a step is caught.
The ``cuda``-marked test audits the replayed graphs on the card.
"""
import contextlib
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

N_PODS, LANES = 2, 4
CYCLES = ("V", "W", "F")
SMOOTHERS = ("jacobi", "chebyshev", "block_jacobi", "hybrid_gs",
             "hybrid_gs_sym")
PAIRS = [(c, s) for c in CYCLES for s in SMOOTHERS]
PROGRAMS = ("resid_norm", "cycle", "vcycle", "pcg_init", "pcg_step",
            "resid_norm_m", "cycle_m", "vcycle_m", "pcg_init_m", "pcg_step_m")
K = 2                 # width of the *_m programs


# --------------------------------------------------------------- JAX side
def _jax_reference(out_path, in_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    from collections import Counter

    import jax.numpy as jnp

    from repro.amg.csr import CSR
    from repro.amg.dist_solve import DistHierarchy
    from repro.amg.hierarchy import Hierarchy, Level
    from repro.amg.solve import SolveOptions
    from repro.analysis import collect_collectives, collective_signature

    d = dict(np.load(in_path))
    levels = []
    for l in range(int(d["n_levels"])):
        ops = {}
        for op in ("A", "P", "R"):
            key = f"L{l}_{op}_"
            ops[op] = (CSR(tuple(int(s) for s in d[key + "shape"]),
                           d[key + "indptr"], d[key + "indices"],
                           d[key + "data"]) if key + "shape" in d else None)
        levels.append(Level(**ops))
    h = Hierarchy(solver=str(d["solver"]), levels=levels,
                  theta=float(d["theta"]))
    dh = DistHierarchy.build(h, N_PODS, LANES, dtype=jnp.float64)
    out = {"expected": {}, "logged": {}, "apply": {}}
    for cycle, smoother in PAIRS:
        opts = SolveOptions(cycle=cycle, smoother=smoother)
        for name in PROGRAMS:
            key = f"{cycle}+{smoother}/{name}"
            out["expected"][key] = dh.expected_collectives(opts, name)
            recs = collect_collectives(dh.trace_program(name, opts, k=K))
            out["logged"][key] = dict(Counter(r.primitive for r in recs))
    for l, dl in enumerate(dh.levels):
        for op in ("A", "P", "R"):
            if getattr(dl, op) is not None:
                out["apply"][f"{l}.{op}"] = [
                    list(dh.expected_apply_signature(l, op)),
                    list(collective_signature(dh.trace_apply(l, op)))]
    pathlib.Path(out_path).write_text(json.dumps(out))


# ------------------------------------------------------------- port side
torch = pytest.importorskip("torch") if __name__ != "__main__" else None

if torch is not None:
    from repro_torch.amg import SolveOptions  # noqa: E402
    from repro_torch.amg.dist_solve import DistHierarchy, dist_pcg  # noqa: E402
    from repro_torch.amg.hierarchy import setup  # noqa: E402
    from repro_torch.amg.problems import laplace_3d  # noqa: E402
    from repro_torch.analysis import (audit_apply, audit_captured,  # noqa: E402
                                      audit_cycle_stats, audit_hierarchy,
                                      audit_log, audit_program, audit_solve,
                                      build_report, check_overlap_independence,
                                      collect_collectives,
                                      collective_signature)
    from repro_torch.analysis.lint import lint_paths, lint_source  # noqa: E402

SRC = pathlib.Path(__file__).parents[1] / "src" / "repro_torch"


@pytest.fixture(scope="module")
def dh11():
    """A small lowered hierarchy on a 1×1 rank grid: every halo is empty,
    but hier_psum / hier_all_gather keep their strategy steps."""
    h = setup(laplace_3d(6), solver="rs", max_coarse=30)
    return DistHierarchy.build(h, 1, 1, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def h8():
    """laplace_3d(8): 3 levels, so W and F cycles revisit coarse levels."""
    return setup(laplace_3d(8), solver="rs", max_coarse=30)


@pytest.fixture(scope="module")
def dh24(h8):
    return DistHierarchy.build(h8, N_PODS, LANES, dtype=torch.float64,
                               device="cpu")


# ------------------------------------------------------- the comm audit
@pytest.mark.parametrize("pods,lanes", [(1, 1), (2, 4)])
def test_hier_collective_golden_signatures(pods, lanes):
    from repro_torch.core.nap_collectives import (ALL_TO_ALL_SIGNATURES,
                                                  GATHER_SIGNATURES,
                                                  REDUCE_SIGNATURES,
                                                  hier_all_gather,
                                                  hier_all_to_all, hier_psum)
    x = torch.arange(pods * lanes * 8, dtype=torch.float64).reshape(-1, 8)
    for strat, expect in REDUCE_SIGNATURES.items():
        log = []
        hier_psum(x, pods, lanes, strat, log=log)
        assert collective_signature(log) == expect, strat
    for strat, expect in GATHER_SIGNATURES.items():
        log = []
        hier_all_gather(x, pods, lanes, strat, log=log)
        assert collective_signature(log) == expect, strat
    chunks = x[:, : pods * lanes]
    for strat, expect in ALL_TO_ALL_SIGNATURES.items():
        log = []
        hier_all_to_all(chunks, pods, lanes, strat, log=log)
        assert collective_signature(log) == expect, strat


@pytest.mark.parametrize("nap", [True, False])
def test_moe_dispatch_logs_two_shuffles(nap):
    """An expert-parallel MoE call is one dispatch and one combine shuffle:
    its log audits clean against twice the all-to-all signature, and a
    shuffle short fails the audit."""
    from repro_torch.configs import get_arch
    from repro_torch.core.nap_collectives import all_to_all_signature
    from repro_torch.models.moe import moe_ffn_ep

    cfg = get_arch("qwen3-moe-235b-a22b").reduced(n_experts=16)
    gen = torch.Generator().manual_seed(0)
    d, f = cfg.d_model, cfg.moe_d_ff
    p = {"router": torch.randn(d, 16, generator=gen),
         "gate": torch.randn(8, 2, d, f, generator=gen),
         "up": torch.randn(8, 2, d, f, generator=gen),
         "down": torch.randn(8, 2, f, d, generator=gen)}
    log = []
    moe_ffn_ep(p, cfg, torch.randn(8, 4, d, generator=gen), (2, 4), nap=nap,
               log=log)
    sig = 2 * all_to_all_signature("nap3" if nap else "flat")
    assert audit_log(log, "moe_ffn_ep", expected_signature=sig).ok
    assert not audit_log(log[1:], "moe_ffn_ep", expected_signature=sig).ok


def test_halo_signature_tables_match_operators():
    """Every strategy's DistOperator states the ordered signature of the
    table and one apply logs it; an empty-halo operator states and logs
    nothing."""
    from repro_torch.amg.csr import CSR
    from repro_torch.amg.dist_spmv import build_dist_operator
    from repro_torch.core.nap_collectives import HALO_SIGNATURES
    rng = np.random.default_rng(0)
    n = 96
    band = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 3
    dense = band * rng.normal(size=(n, n))
    r, c = np.nonzero(dense)
    A = CSR.from_coo(r, c, dense[r, c], (n, n))
    x = torch.ones((N_PODS * LANES, 12), dtype=torch.float64)
    for strat, expect in HALO_SIGNATURES.items():
        op = build_dist_operator(A, N_PODS, LANES, strat, dtype=np.float64)
        assert not op.halo_empty
        assert op.expected_signature == expect, strat
        for overlap in (True, False):
            log = []
            op.apply(op.to_device(torch.device("cpu"), torch.float64), x,
                     overlap=overlap, log=log)
            assert tuple(log) == expect, (strat, overlap)
    diag = CSR.from_coo(np.arange(n), np.arange(n), np.ones(n), (n, n))
    op = build_dist_operator(diag, N_PODS, LANES, "nap3", dtype=np.float64)
    log = []
    op.apply(op.to_device(torch.device("cpu"), torch.float64), x, log=log)
    assert op.halo_empty and op.expected_signature == () and log == []


def test_program_audits_clean_1x1(dh11):
    for name in ("resid_norm", "vcycle", "pcg_init", "pcg_step_m"):
        a = audit_program(dh11, name)
        assert a.ok, [str(v) for v in a.violations]
        assert a.counts == a.expected
    for cycle in CYCLES:
        a = audit_program(dh11, "vcycle", SolveOptions(cycle=cycle))
        assert a.ok, (cycle, [str(v) for v in a.violations])
    for level in range(len(dh11.levels)):
        for op in ("A", "P", "R"):
            if getattr(dh11.levels[level], op) is not None:
                ap = audit_apply(dh11, level, op)
                assert ap.ok and ap.n_collectives == 0, (level, op)
    assert audit_cycle_stats(dh11) == []


def test_full_grid_audit_clean_2x4(dh24):
    """The whole sweep on 2×4: every program × V/W/F × the five smoothers,
    every apply (with the poisoned-halo check), the modeled counters."""
    audits, violations = audit_hierarchy(dh24)
    assert violations == [], [str(v) for v in violations]
    n_ops = sum(getattr(dl, op) is not None for dl in dh24.levels
                for op in ("A", "P", "R"))
    assert len(audits) == len(PAIRS) * len(PROGRAMS) + n_ops
    assert all(a.counts == a.expected for a in audits)
    # W and F revisit the coarse levels: more exchanges than V
    v, w = (next(a for a in audits if a.program == f"vcycle[{c}+jacobi]")
            for c in ("V", "W"))
    assert w.n_collectives > v.n_collectives


def test_injected_flat_psum_detected(h8, monkeypatch):
    """hier_psum silently replaced by a flat psum passes every parity gate
    (the same numbers) but must fail the count cross-check."""
    import repro_torch.amg.dist_solve as ds
    real = ds.hier_psum
    monkeypatch.setattr(
        ds, "hier_psum",
        lambda x, pods, lanes, strategy="nap3", log=None:
        real(x, pods, lanes, "flat", log=log))
    dh_bad = ds.DistHierarchy.build(h8, N_PODS, LANES, dtype=torch.float64,
                                    device="cpu")
    bad = audit_program(dh_bad, "resid_norm")
    assert not bad.ok
    assert any(v.kind == "count-mismatch" for v in bad.violations)
    assert bad.counts.get("psum_scatter", 0) == 0   # the scatter leg vanished
    assert bad.expected["psum_scatter"] >= 1


def test_injected_empty_halo_collective_detected(dh11, monkeypatch):
    """A collective re-introduced on an empty-halo level must be caught:
    forcing the apply down the exchange path while the plan moves nothing
    violates the zero-collective contract."""
    from repro_torch.amg.dist_spmv import DistOperator
    assert dh11.levels[0].A.halo_empty           # 1×1: nothing to exchange
    monkeypatch.setattr(DistOperator, "halo_empty",
                        property(lambda self: False))
    a = audit_apply(dh11, 0, "A")
    assert not a.ok
    assert any(v.kind == "empty-halo-collective" for v in a.violations)
    assert a.n_collectives > 0


def test_overlap_poisoned_halo_check(dh24):
    """With the halo poisoned, the overlapped apply's ``A_on`` product is
    unchanged and only its ``A_off`` product sees the poison; the serial
    form, and a body that reads the halo before ``A_on``, fail."""
    from repro_torch.amg import dist_spmv
    dop, arrs = dh24.levels[0].A, dh24._arrs[0]["A"]
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (N_PODS * LANES, dop.plan.local_n)))
    good = check_overlap_independence(dop, arrs, x)
    assert good.ok and good.exchanged
    assert good.unchanged == (True, False) and good.poisoned == (False, True)
    serial = check_overlap_independence(
        dop, arrs, x, apply=lambda: dop.apply(arrs, x, overlap=False))
    assert not serial.ok and serial.unchanged == (False,)

    def halo_first():
        halo = dist_spmv.halo_exchange(x, dop.plan, arrs["send"],
                                       arrs["recv"], arrs["psel"])
        xh = x + 0.0 * halo.sum()
        y = dop._on_product(arrs, xh, True)
        return y + dop._ell_product(arrs["off_cols"], arrs["off_vals"],
                                    halo, True)

    assert not check_overlap_independence(dop, arrs, x, apply=halo_first).ok
    # nothing of the check is left behind on the operator or the module
    assert "_ell_product" not in dop.__dict__
    assert dist_spmv.halo_exchange.__module__.endswith("nap_collectives")


def test_serialized_apply_is_reported(dh24, monkeypatch):
    from repro_torch.amg.dist_spmv import DistOperator
    real = DistOperator.apply
    monkeypatch.setattr(DistOperator, "apply",
                        lambda self, arrs, x, use_kernel=True, overlap=True,
                        log=None, side=None:
                        real(self, arrs, x, use_kernel, False, log, side))
    a = audit_apply(dh24, 0, "A")
    assert [v.kind for v in a.violations] == ["overlap-serialized"]


def test_audit_report_roundtrip(dh11):
    a = audit_program(dh11, "resid_norm")
    rep = build_report(audits=[a], meta={"pods": 1, "lanes": 1})
    assert rep["summary"]["ok"]
    assert rep["comm_audit"][0]["counts"] == a.counts
    json.loads(json.dumps(rep))                     # fully serializable
    for i, r in enumerate(rep["comm_audit"][0]["records"]):
        assert r["primitive"] in ("psum", "psum_scatter", "all_gather",
                                  "all_to_all")
        assert r["index"] == i


def test_analysis_cli_on_the_cpu(tmp_path):
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "report.json"
    assert main(["--device", "cpu", "--n", "6", "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["summary"]["ok"] and rep["meta"]["device"] == "cpu"
    assert rep["summary"]["programs_audited"] >= len(PAIRS) * len(PROGRAMS)
    # the setup exchanges of a plain and an aggressive partitioned setup
    ops = {r["op"] for r in rep["setup_audit"]}
    assert {"spgemm_AP", "spgemm_PtAP", "spgemm_S2"} <= ops
    assert rep["meta"]["setup_exchanges_audited"] == len(rep["setup_audit"])


# ------------------------------------------------------------- the lint
def _lint(src):
    return lint_source(textwrap.dedent(src), "mod.py")


def test_lint_async_blocking_bad_coroutine():
    vs = _lint("""
        import time

        async def handler(svc, t):
            x = t.result(timeout=5)
            svc.update_wire(x)
            time.sleep(1)
            return x
        """)
    assert [v.rule for v in vs].count("async-blocking") == 3, vs


def test_lint_async_blocking_sanctioned_forms_pass():
    vs = _lint("""
        import asyncio

        async def handler(tenant, payload, t, writer):
            await asyncio.to_thread(tenant.service.update_wire, payload)
            await writer.drain()

            def _resolve():                     # sync scope resets the rule
                return t.result(timeout=0)

            fut = asyncio.get_event_loop().create_future()
            fut.set_result(_resolve())          # set_result is not blocking
            return await fut
        """)
    assert vs == []


def test_lint_raw_collective_and_markers():
    bad = _lint("""
        import torch
        import torch.distributed as dist
        from torch.distributed import all_reduce
        from repro_torch.core.nap_collectives import _all_to_all

        def f(x, log):
            torch.distributed.all_reduce(x)
            dist.broadcast(x, 0)
            all_reduce(x)
            return _all_to_all(x, 0, 2, log)
        """)
    assert [v.rule for v in bad] == ["raw-collective"] * 4, bad
    allowed = _lint("""
        import torch

        def f(x):
            torch.distributed.all_reduce(x)  # comm-audit: allow grad-sync
        """)
    assert allowed == []
    filewide = _lint("""
        # comm-audit: allow-file raw-collective
        import torch.distributed as dist

        def f(x):
            dist.all_gather_into_tensor(x, x)
        """)
    assert filewide == []
    # the public collectives are what the rule asks for, anywhere
    public = _lint("""
        from repro_torch.core.nap_collectives import hier_all_to_all

        def f(x, log):
            return hier_all_to_all(x, 2, 4, "nap3", log=log)
        """)
    assert public == []
    # the collectives' own module is where the private helpers live
    core = lint_source("def f(v, log):\n    return _all_to_all(v, 0, 2, log)\n",
                       "src/repro_torch/core/nap_collectives.py")
    assert core == []


def test_lint_captured_host_call():
    vs = _lint("""
        import time
        import torch

        class DistHierarchy:
            def _pdot(self, a, b):
                return (a * b).sum().item()

            def _helper(self, r):
                print(r)
                return self._pdot(r, r).cpu()

            def resid_norm(self, x, b, opts):
                torch.cuda.synchronize()
                return self._helper(b - x) * time.perf_counter()

            resid_norm_m = resid_norm

            def gather(self, x):                # not captured: fine
                return x.cpu().numpy().tolist()

        def host_side(x):                       # not captured: fine
            return x.item()
        """)
    assert [(v.rule, v.line) for v in vs] == [
        ("captured-host-call", 7), ("captured-host-call", 10),
        ("captured-host-call", 11), ("captured-host-call", 14),
        ("captured-host-call", 15)], vs
    other = _lint("""
        class Engine:
            def pcg_step(self, x):              # another class: not captured
                return x.item()
        """)
    assert other == []


def test_lint_frozen_mutation():
    vs = _lint("""
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class Cfg:
            a: int = 0

            def __post_init__(self):
                object.__setattr__(self, "a", 1)    # allowed here

        def f(c: Cfg):
            c.a = 2
            object.__setattr__(c, "a", 3)
            return dataclasses.replace(c, a=4)      # the sanctioned route

        def g():
            c = Cfg()
            c.a = 5
            return c
        """)
    assert [v.rule for v in vs] == ["frozen-mutation"] * 3, vs


def test_lint_clean_tree():
    """The port's own source carries zero violations."""
    assert lint_paths(SRC) == []


def test_lint_keeps_torch_distributed_in_nap_collectives(capsys):
    """The process-group back-end's ``torch.distributed`` calls live in
    ``core/nap_collectives.py``, where the rule allows them; the same call
    appended to any other port module is flagged, and ``python -m
    repro_torch.analysis --lint-only`` passes on the tree."""
    from repro_torch.analysis.__main__ import main

    core = SRC / "core" / "nap_collectives.py"
    src = core.read_text()
    assert "dist.all_to_all_single(" in src and "dist.init_process_group(" in src
    assert lint_source(src, str(core)) == []
    call = "\n\ndef _probe(x):\n    torch.distributed.all_reduce(x)\n"
    others = [p for p in sorted(SRC.rglob("*.py")) if p != core]
    assert len(others) > 50
    for path in others:
        text = path.read_text() + call
        got = [(v.rule, v.line) for v in lint_source(text, str(path))]
        assert got == [("raw-collective", text.count("\n"))], path
    assert main(["--lint-only"]) == 0
    assert "lint" in capsys.readouterr().out


# ---------------------------------------------- against the reference
@pytest.fixture(scope="module")
def reference(h8, tmp_path_factory):
    from repro_torch.convert import hierarchy_to_arrays
    tmp = tmp_path_factory.mktemp("jax_ref")
    in_path, out_path = tmp / "in.npz", tmp / "out.json"
    np.savez(in_path, **hierarchy_to_arrays(h8))
    env = dict(os.environ)
    root = pathlib.Path(__file__).parents[1]
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, __file__, "--jax-ref", str(out_path), str(in_path)],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    return json.loads(out_path.read_text())


@pytest.mark.parametrize("cycle,smoother", PAIRS,
                         ids=[f"{c}-{s}" for c, s in PAIRS])
def test_count_model_and_logs_match_reference(reference, dh24, cycle,
                                              smoother):
    """For the same host hierarchy on 2×4, every program's count model
    equals the reference's, and its logged counts equal the reference's
    jaxpr-walked counts."""
    opts = SolveOptions(cycle=cycle, smoother=smoother)
    for name in PROGRAMS:
        key = f"{cycle}+{smoother}/{name}"
        assert dh24.expected_collectives(opts, name) \
            == reference["expected"][key], key
        logged = audit_program(dh24, name, opts, k=K).counts
        assert logged == reference["logged"][key], key


def test_apply_signatures_match_reference(reference, dh24):
    got = {}
    for l, dl in enumerate(dh24.levels):
        for op in ("A", "P", "R"):
            if getattr(dl, op) is not None:
                got[f"{l}.{op}"] = [list(dh24.expected_apply_signature(l, op)),
                                    list(collective_signature(
                                        dh24.trace_apply(l, op)))]
    assert got == reference["apply"]


# --------------------------------------------------- under capture
class StandInGraph:
    """Plays a torch.cuda.CUDAGraph: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _captured(h, names, opts):
    dh = DistHierarchy.build(h, N_PODS, LANES, dtype=torch.float64,
                             device="cpu")
    for name in names:
        k = K if name.endswith("_m") else None
        dh.programs.get(name, opts, k).capture(StandInGraph(),
                                               contextlib.nullcontext())
    return dh


def test_replayed_logs_audit_clean(h8):
    """Programs captured into stand-in graphs: their recorded logs audit
    clean, each replay adds exactly that log, and a replayed PCG's log is
    the sum of its program calls."""
    opts = SolveOptions(cycle="W", smoother="chebyshev")
    dh = _captured(h8, PROGRAMS, opts)
    audits = audit_captured(dh)
    assert len(audits) == len(PROGRAMS) and all(a.ok for a in audits), \
        [str(v) for a in audits for v in a.violations]
    for name in PROGRAMS:
        assert audit_program(dh, name, opts, k=K).ok, name
    b = np.random.default_rng(1).standard_normal(h8.levels[0].A.nrows)
    init, step = (dh.programs.get(n, opts) for n in ("pcg_init", "pcg_step"))
    before = init.replays, step.replays
    dh.comm_log = []
    res = dist_pcg(dh, b, tol=0.0, maxiter=4, opts=opts)
    calls = {"pcg_init": init.replays - before[0],
             "pcg_step": step.replays - before[1]}
    assert calls == {"pcg_init": 1, "pcg_step": len(res.residuals) - 1}
    assert dh.comm_log == init.comm + step.comm * calls["pcg_step"]
    assert audit_solve(dh, dh.comm_log, calls, opts).ok


@pytest.mark.parametrize("name", ["pcg_step", "vcycle_m", "resid_norm"])
def test_replay_missing_a_step_is_caught(h8, name):
    opts = SolveOptions()
    dh = _captured(h8, [name], opts)
    prog = dh.programs.values()[0]
    dropped = prog.comm.pop(len(prog.comm) // 2)
    a = audit_program(dh, name, opts, k=K)
    assert not a.ok
    assert [v.kind for v in a.violations] == ["count-mismatch"]
    assert a.counts.get(dropped, 0) == a.expected[dropped] - 1
    assert not audit_captured(dh)[0].ok


def test_collect_collectives_attributes_level_and_op():
    recs = collect_collectives(["all_to_all", "all_gather"], level=2, op="P")
    assert [(r.primitive, r.index, r.level, r.op) for r in recs] == [
        ("all_to_all", 0, 2, "P"), ("all_gather", 1, 2, "P")]


# ------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_audit_over_replayed_graphs_on_the_card(cuda):
    """laplace_3d(16) on 2×4 on the card: every program of the grid is a
    captured graph, and the logs its replays add audit clean."""
    h = setup(laplace_3d(16), solver="rs")
    dh = DistHierarchy.build(h, N_PODS, LANES, dtype=torch.float64,
                             device=cuda)
    audits, violations = audit_hierarchy(dh)
    assert violations == [], [str(v) for v in violations]
    progs = dh.programs.values()
    assert len(progs) == len(PAIRS) * len(PROGRAMS)
    assert all(p.graph is not None and p.replays == 1 for p in progs)
    assert all(a.ok for a in audit_captured(dh))


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "--jax-ref":
        sys.exit("usage: test_torch_analysis.py --jax-ref OUT.json IN.npz")
    _jax_reference(sys.argv[2], sys.argv[3])
