"""The port's dry-run (``repro_torch.launch.dryrun``) on a fake (2, 2, 2)
(pod, data, model) mesh, held to the reference's where the two can be
compared, and to real runs.

* The four cases of ``tests/dryrun_small_script.py`` trace at the script's
  reduced configs, with FLOPs a device > 0.
* One subprocess with 8 XLA host devices runs the reference's
  ``build_cell`` on those cases (on a mesh it builds with ``Auto`` axes:
  ``jax.make_mesh``'s default ``Explicit`` axes refuse its
  ``with_sharding_constraint``s under jax 0.9) and its distributed SpMV at
  (2, 4).  A DTensor trace cannot equal XLA's HLO, so the collectives are
  compared by kind and by the mesh axes their groups span, not by value:
  in a train cell both sides run reduce-scatters or all-reduces over the
  dp axes (the gradient reduction), and every collective that crosses pods
  and is larger than a scalar runs over dp axes only (no model-axis
  traffic crosses pods); in the serving cells both sides sum over the
  model axis, mixtral's both dispatch its experts over the data axis, and
  nothing crosses pods (but in the reference's xlstm-125m long_500k, whose
  batch of one is not sharded, XLA still reduces small buffers over the dp
  axes: 384 bytes and less).  The
  reference's train cell also has collective-permutes over all three axes:
  GSPMD resharding the microbatch split (``reshape((mb, B // mb, ...))``
  of a dp-sharded batch); the port splits each rank's own rows and has
  none, so they are left out of the comparison.
* The AMG cell at (2, 4) per strategy: a rank's collective bytes and
  pod-crossing bytes equal the reference's ``collective_bytes_from_text``.
  Both count each collective's result buffer a device: the port's stacked
  exchange records the same buffers (a standard exchange's two
  all-to-alls, NAP-2's all-to-all and lane all-gather, NAP-3's gather,
  all-to-all and gather), so the bytes agree exactly.
* The probes' linear extrapolation equals the full-depth trace's counts at
  a small depth; their peak-memory estimate equals the trace's peak for a
  dense train cell and falls short for recurrentgemma's prefill (the
  reason is at the test).
* Fake against real: 8 real gloo processes on the CPU run one sharded
  ZeRO-2 step; its collective log equals the fake trace's op for op, and
  its loss, grad_norm, AdamW moments and parameters equal the one-device
  step's (``test_torch_train_step.assert_step_matches``: m and v at 1e-4
  of their max, the parameters at 0.01 lr where the gradient stands clear
  of its rounding).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

CASES = [("qwen2-0.5b", "train_4k"), ("mixtral-8x22b", "decode_32k"),
         ("xlstm-125m", "long_500k"), ("recurrentgemma-9b", "prefill_32k")]
AXES = ("pod", "data", "model")
AMG_N = 8


def _small(get_arch, arch):
    """The small script's reduced config."""
    cfg = get_arch(arch).reduced(n_layers=len(get_arch(arch).pattern),
                                 d_model=64, n_heads=4, vocab=256)
    return dataclasses.replace(cfg, name=arch)


def _axes_of(groups, coords) -> tuple:
    """The mesh axes along which a group's members differ."""
    out = set()
    for g in groups:
        cs = np.array([coords[d] for d in g])
        out |= {AXES[i] for i in range(cs.shape[1])
                if len(set(cs[:, i])) > 1}
    return tuple(a for a in AXES if a in out)


def _jax_reference(out_path):
    """Runs in a subprocess with 8 host devices."""
    import jax
    from jax.sharding import AxisType

    from repro.amg.dist_spmv import build_dist_spmv
    from repro.amg.problems import laplace_3d
    from repro.configs import get_arch
    from repro.launch.dryrun import build_cell
    from repro.launch.roofline import (_parse_groups, _COLL_RE,
                                       collective_bytes_from_text,
                                       parse_collectives)

    mesh = jax.make_mesh((2, 2, 2), AXES, axis_types=(AxisType.Auto,) * 3)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    coords = {int(ids[c]): c for c in np.ndindex(ids.shape)}
    out = {"cells": {}, "amg": {}}
    for arch, shape in CASES:
        lowered, _ = build_cell(arch, shape, mesh,
                                cfg_override=_small(get_arch, arch),
                                microbatches=2 if shape == "train_4k" else None,
                                unroll=True)
        text = lowered.compile().as_text()
        rows = []
        for line in text.splitlines():
            m = _COLL_RE.search(line)
            if not m or m.group("suffix") == "-done":
                continue
            info = parse_collectives(line, pod_size=4, n_devices=8)[0]
            groups = _parse_groups(line) or [list(range(8))]
            rows.append({"op": info.op, "bytes": info.bytes,
                         "cross": info.crosses_pod,
                         "axes": _axes_of(groups, coords)})
        out["cells"][f"{arch} {shape}"] = rows
    amesh = jax.make_mesh((2, 4), ("pod", "lane"),
                          axis_types=(AxisType.Auto,) * 2)
    A = laplace_3d(AMG_N)
    for strat in ("standard", "nap2", "nap3"):
        sp = build_dist_spmv(A, 2, 4, strat, mesh=amesh)
        x = sp.scatter_x(np.ones(A.nrows))
        text = jax.jit(sp.fn).lower(x).compile().as_text()
        out["amg"][strat] = collective_bytes_from_text(text, pod_size=4,
                                                       n_devices=8)
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] != "--jax-ref":
        sys.exit("usage: test_torch_dryrun.py --jax-ref OUT.json")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    _jax_reference(sys.argv[2])
    sys.exit(0)

# ------------------------------------------------------------- port side
torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.roofline import collective_totals  # noqa: E402
from repro_torch.train.train_step import TrainOptions  # noqa: E402


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(pathlib.Path(__file__).parents[1] / "src")
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, __file__, "--jax-ref", str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((2, 2, 2), AXES, device_type="cpu")


@pytest.fixture(scope="module")
def traced(mesh):
    """The port's trace of each small-script case."""
    out = {}
    coords = {int(mesh.mesh[c]): c for c in np.ndindex(tuple(mesh.mesh.shape))}
    for arch, shape in CASES:
        r = dryrun._compile_cell(
            arch, shape, mesh, 4, cfg_override=_small(get_arch, arch),
            microbatches=2 if shape == "train_4k" else None)
        r["rows"] = [{"op": e.op, "bytes": e.bytes,
                      "cross": bool(e.ranks) and len({d // 4 for d in
                                                      e.ranks}) > 1,
                      "axes": _axes_of([e.ranks], coords)}
                     for e in r["log"]]
        out[f"{arch} {shape}"] = r
    return out


@pytest.mark.parametrize("case", [f"{a} {s}" for a, s in CASES])
def test_small_cases_trace_with_flops(traced, case):
    r = traced[case]
    assert r["flops"] > 0 and r["bytes"] > 0 and r["peak_bytes"] > 0
    assert r["meta"]["n_devices"] == 8 and r["meta"]["mesh"] == "2x2x2"
    assert r["coll"] == collective_totals(r["log"], pod_size=4, n_devices=8)


@pytest.mark.parametrize("case", [f"{a} {s}" for a, s in CASES])
def test_collectives_by_kind_and_axis_against_reference(reference, traced,
                                                        case):
    port, ref = traced[case]["rows"], reference["cells"][case]
    for side, rows in (("port", port), ("reference", ref)):
        assert rows, side
        crossing = [r for r in rows if r["cross"] and r["bytes"] > 8
                    and r["op"] != "collective-permute"]
        kinds = {(r["op"], tuple(r["axes"])) for r in rows}
        if case.endswith("train_4k"):
            # the gradient reduction over the dp axes
            assert any(r["op"] in ("reduce-scatter", "all-reduce")
                       and set(r["axes"]) & {"pod", "data"}
                       and "model" not in r["axes"] for r in rows), side
            # the only pod-crossing traffic: over dp axes
            assert crossing and all("model" not in r["axes"]
                                    for r in crossing), (side, crossing)
            continue
        # serving: the tensor-parallel sums over the model axis
        assert ("all-reduce", ("model",)) in kinds, (side, kinds)
        if case.startswith("mixtral"):
            # the expert-parallel dispatch over the data axis
            assert ("all-to-all", ("data",)) in kinds, (side, kinds)
        if side == "port" or not case.startswith("xlstm"):
            assert not crossing, (side, crossing)


@pytest.mark.parametrize("strategy", ["standard", "nap2", "nap3"])
def test_amg_cell_bytes_match_reference(reference, strategy):
    got = dryrun.run_amg_cell(multi_pod=True, n=AMG_N, strategies=(strategy,),
                              verbose=False, device="cpu", lanes=4,
                              dtype=torch.float32)[0]
    want = reference["amg"][strategy]
    assert got["halo_bit_equal"]
    assert got["n_collectives"] == want["n_collectives"]
    assert got["coll_bytes_per_dev"] == want["total_bytes"]
    assert got["cross_pod_bytes_per_dev"] == want["cross_slow_bytes"]


@pytest.mark.parametrize("arch,shape", [("qwen3-1.7b", "train_4k"),
                                        ("recurrentgemma-9b", "prefill_32k")])
def test_probe_extrapolation_equals_full_depth(mesh, arch, shape):
    cfg = dataclasses.replace(get_arch(arch).reduced(
        n_layers=4 * len(get_arch(arch).pattern), d_model=64, n_heads=4,
        vocab=256), name=arch)
    full = dryrun._compile_cell(arch, shape, mesh, 4, cfg_override=cfg,
                                microbatches=1)
    meta = dryrun.run_cell(arch, shape, mesh=mesh, cfg_override=cfg,
                           microbatches=1, verbose=False)
    assert meta["flops_per_dev"] == full["flops"]
    # the unfused bytes: exact for the dense train cell; recurrentgemma's
    # prefill stacks its recurrent states over the groups, which DTensor
    # copies otherwise for one group than for several (12 KiB more or less,
    # of 3.5 TB)
    assert abs(meta["bytes_per_dev"] - full["bytes"]) <= (
        0 if arch == "qwen3-1.7b" else 1e-7 * full["bytes"])
    assert meta["coll_bytes_per_dev"] == full["coll"]["total_bytes"]
    assert meta["cross_pod_bytes_per_dev"] == full["coll"]["cross_slow_bytes"]
    assert meta["n_collectives"] == full["coll"]["n_collectives"]
    assert meta["peak_from"] == "production trace"
    # the probes alone (the smoke's dry-run phase): the same counts, and
    # the peak live bytes extrapolated, an estimate: exact for the dense
    # train cell; recurrentgemma's prefill peaks in its first group's
    # attention at 1 to 3 groups (one more residual-sized copy alive there)
    # and in the last group's from 4 on (each earlier group's caches
    # alive), so the probes miss the caches' growth: under by 8.4 MB of
    # 6.65 GB (0.13%) at 4 groups, by one group's caches more for each
    # group past that
    alone = dryrun.run_cell(arch, shape, mesh=mesh, cfg_override=cfg,
                            microbatches=1, verbose=False, production=False)
    assert alone["peak_from"] == "probes"
    assert alone["flops_per_dev"] == full["flops"]
    assert alone["model_flops"] == meta["model_flops"]
    short = full["peak_bytes"] - alone["peak_bytes_per_dev"]
    if arch == "qwen3-1.7b":
        assert short == 0
    else:
        assert 0 <= short <= 2e-3 * full["peak_bytes"], short


def test_flash_kernel_traces_as_a_custom_op(mesh):
    """``use_kernel=True``: the prefill traces flash through its custom
    operator's fake rank by rank, with the same collectives as the plain
    attention (the kernel's FLOPs are not counted: an opaque op)."""
    cfg = _small(get_arch, "qwen3-1.7b")
    kw = dict(cfg_override=cfg, microbatches=None)
    plain = dryrun._compile_cell("qwen3-1.7b", "prefill_32k", mesh, 4, **kw)
    flash = dryrun._compile_cell("qwen3-1.7b", "prefill_32k", mesh, 4,
                                 use_kernel=True, **kw)
    assert [e.key() for e in flash["log"]] == [e.key() for e in plain["log"]]
    assert 0 < flash["flops"] < plain["flops"]


def test_fake_trace_equals_real_gloo_step(mesh):
    import torch.distributed as dist

    from repro_torch.launch.ranks import spawn
    from repro_torch.models.model import init_lm
    from repro_torch.train.optimizer import (AdamWConfig, init_opt_state,
                                             schedule)
    from repro_torch.train.train_step import make_step_fn
    from test_torch_train_step import assert_step_matches

    cfg = get_arch("qwen2-0.5b").reduced(n_layers=2, d_model=64, n_heads=4,
                                         vocab=256)
    rng = np.random.default_rng(0)
    inp = rng.integers(0, cfg.vocab, (8, 16))
    tgt = rng.integers(0, cfg.vocab, (8, 16))
    opts = TrainOptions(remat=False, microbatches=2, dp_axes=("pod", "data"),
                        zero2=True)
    fake = dryrun.sharded_step(mesh, cfg, inp, tgt, opts, fake=True)
    real = spawn(dryrun.sharded_step_rank, 2, 4, (cfg, inp, tgt, opts))[0]
    assert real["log"] == fake["log"] and len(real["log"]) > 50
    kinds = {e[0] for e in real["log"]}
    assert {"reduce-scatter", "all-gather", "all-reduce"} <= kinds
    model = init_lm(cfg, 0, torch.float32, "cpu", trainable=True)
    step = make_step_fn(cfg, AdamWConfig(), TrainOptions(remat=False,
                                                         microbatches=2))
    _, opt, om = step(model, init_opt_state(dict(model.named_parameters())),
                      {"inputs": torch.as_tensor(inp),
                       "targets": torch.as_tensor(tgt)})
    assert_step_matches(real, model, opt, om, schedule(AdamWConfig(), 1))
    assert dist.get_world_size() == 8        # the module's fake group
