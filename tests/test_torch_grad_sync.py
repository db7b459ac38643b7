"""The port's node-aware gradient sync (``hier_grad_sync``, the paper's
NAP-3 on data-parallel gradients, with an optional int8 slow leg and error
feedback) against the reference's under ``shard_map`` on 8 host devices (a
JAX subprocess of this file, mesh ("pod", "lane") = 2 x 4), and its process
form on 8 gloo ranks against the stacked form:

- on random normal gradients (a tree of a [5, 7] matrix, a [3] vector, a
  scalar and a [2, 4] block: pads on the slow-leg pieces): flat and nap3 at
  1e-5 of max|g| (the sums' orders differ); nap3 + int8 over two steps (the
  second fed the first's error feedback) at 3e-2 (a piece that rounds one
  ulp away moves a code by one step, 1/127 of the piece's max, times the
  pods) and the error feedback at 5e-3;
- on dyadic gradients (small integers over 2^10: every sum exact in any
  order) all three bit-equal between the stacked form and the gloo ranks,
  flat and nap3 bit-equal to the reference too, int8 within 1e-6 of it
  (the same codes; XLA rounds the scale's division and the dequantize an
  ulp apart from torch in places);
- each call's collective log equal to the reference's legs as its jaxpr
  lowers them (psum; psum_scatter, psum, all_gather; psum_scatter,
  all_gather x 3 for each leaf);
- the gloo ranks' tallies: the slow group carries 1/|fast| of a slow-group
  all-reduce of the whole gradient, and with int8 those elements are one
  byte each (gloo takes int8 for the all-gather)::

    python tests/test_torch_grad_sync.py --jax-ref OUT.npz
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

N_PODS, LANES = 2, 4
D = N_PODS * LANES
SHAPES = {"w": (5, 7), "b": (3,), "s": (), "blk": (2, 4)}
RUNS = ("flat", "nap3", "int8")
TOL = {"flat": 1e-5, "nap3": 1e-5, "int8": 3e-2}
EF_TOL = 5e-3
# the reference's collective primitives as the port's log names them
PRIMS = {"psum": "psum", "psum2": "psum", "psum_invariant": "psum",
         "reduce_scatter": "psum_scatter", "all_gather": "all_gather",
         "all_gather_invariant": "all_gather"}


def _grads(kind: str, step: int) -> dict:
    rng = np.random.default_rng(10 * step + (kind == "dyadic"))
    out = {}
    for name, shape in SHAPES.items():
        g = rng.standard_normal((D,) + shape)
        if kind == "dyadic":
            g = np.round(g * 64) / 1024
        out[name] = g.astype(np.float32)
    return out


def _collectives(jaxpr) -> list:
    names = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in PRIMS:
            names.append(PRIMS[eqn.primitive.name])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    names += _collectives(inner)
    return names


def _jax_reference(out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core.compat import shard_map
    from repro.train.grad_sync import hier_grad_sync

    mesh = jax.make_mesh((N_PODS, LANES), ("pod", "lane"))
    spec = P(("pod", "lane"))
    out = {}
    for kind in ("random", "dyadic"):
        for run in RUNS:
            strategy = "flat" if run == "flat" else "nap3"
            compress = run == "int8"

            def body(g, ef):
                g = jax.tree.map(lambda a: a[0], g)
                ef = jax.tree.map(lambda a: a[0], ef) if compress else None
                s, e = hier_grad_sync(g, "pod", "lane", strategy, compress, ef)
                e = e if compress else jax.tree.map(jnp.zeros_like, g)
                return (jax.tree.map(lambda a: a[None], s),
                        jax.tree.map(lambda a: a[None], e))

            f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                  out_specs=(spec, spec), check_vma=False))
            ef = {n: np.zeros((D, -(-int(np.prod(s)) // LANES)), np.float32)
                  for n, s in SHAPES.items()}
            if not compress:
                ef = {n: np.zeros((D,) + s, np.float32)
                      for n, s in SHAPES.items()}
            for step in (0, 1):
                g = _grads(kind, step)
                if step == 0 and kind == "random":
                    out[f"log_{run}"] = np.array(_collectives(
                        jax.make_jaxpr(f)(g, ef).jaxpr))
                synced, ef = f(g, ef)
                ef = jax.tree.map(np.asarray, ef)
                for n in SHAPES:
                    out[f"{kind}_{run}_{step}_{n}"] = np.asarray(synced[n])
                    if compress:
                        out[f"{kind}_{run}_{step}_ef_{n}"] = ef[n]
    np.savez(out_path, **out)


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] != "--jax-ref":
        sys.exit("usage: test_torch_grad_sync.py --jax-ref OUT.npz")
    _jax_reference(sys.argv[2])
    sys.exit(0)

torch = pytest.importorskip("torch")

from repro_torch.train.grad_sync import (INT8_TAG, hier_grad_sync,  # noqa: E402
                                         init_error_feedback)


def _sync(run, g, ef, ranks=None):
    log = []
    strategy = "flat" if run == "flat" else "nap3"
    s, e = hier_grad_sync(g, N_PODS, LANES, strategy,
                          compress_slow=run == "int8", error_feedback=ef,
                          log=log, ranks=ranks)
    return s, e, log


def _stacked(kind):
    """{(run, step): (synced, ef, log)} of the stacked form, numpy."""
    out = {}
    for run in RUNS:
        ef = None
        for step in (0, 1):
            g = {n: torch.from_numpy(a) for n, a in _grads(kind, step).items()}
            s, ef, log = _sync(run, g, ef)
            out[(run, step)] = ({n: t.numpy() for n, t in s.items()},
                                None if run != "int8" else
                                {n: t.numpy() for n, t in ef.items()}, log)
    return out


def _rank(ranks):
    """One gloo rank: every run on its row of both inputs, its log and the
    elements it sent by (group, tag) in the first step of each run."""
    d = ranks.rank
    out = {}
    for kind in ("random", "dyadic"):
        for run in RUNS:
            ef = None
            for step in (0, 1):
                g = {n: torch.from_numpy(a[d:d + 1])
                     for n, a in _grads(kind, step).items()}
                ranks.reset_tally()
                s, ef, log = _sync(run, g, ef, ranks)
                out[(kind, run, step)] = (
                    {n: t[0].numpy() for n, t in s.items()},
                    None if run != "int8" else
                    {n: t[0].numpy() for n, t in ef.items()},
                    log, dict(ranks.sent))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.ranks import spawn

    out_path = tmp_path_factory.mktemp("grad_sync_ref") / "out.npz"
    env = dict(os.environ)
    root = pathlib.Path(__file__).parents[1]
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get("PYTHONPATH", "")
    jax_ref = subprocess.Popen(
        [sys.executable, __file__, "--jax-ref", str(out_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = spawn(_rank, N_PODS, LANES, deadline=120.0)
        stdout, stderr = jax_ref.communicate(timeout=300)
    finally:
        if jax_ref.poll() is None:
            jax_ref.kill()
            jax_ref.communicate()
    assert jax_ref.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    return dict(np.load(out_path)), ranks


@pytest.mark.parametrize("run", RUNS)
def test_stacked_matches_reference(runs, run):
    ref = runs[0]
    got = _stacked("random")
    for step in (0, 1):
        synced, ef, log = got[(run, step)]
        assert log == list(ref[f"log_{run}"])
        for n in SHAPES:
            want = ref[f"random_{run}_{step}_{n}"]
            g = _grads("random", step)[n]
            assert synced[n].shape == want.shape
            assert np.abs(synced[n] - want).max() <= TOL[run] * np.abs(g).max()
            if run == "int8":
                wef = ref[f"random_{run}_{step}_ef_{n}"]
                assert ef[n].shape == wef.shape
                assert np.abs(ef[n] - wef).max() <= EF_TOL * np.abs(g).max()
        if run != "int8":        # the mean of the ranks' gradients
            for n in SHAPES:
                mean = _grads("random", step)[n].astype(np.float64).mean(0)
                assert np.abs(synced[n] - mean).max() <= 1e-6


@pytest.mark.parametrize("run", RUNS)
def test_dyadic_stacked_equals_gloo_and_reference(runs, run):
    ref, ranks = runs
    got = _stacked("dyadic")
    for step in (0, 1):
        synced, ef, _ = got[(run, step)]
        for n in SHAPES:
            want = ref[f"dyadic_{run}_{step}_{n}"]
            if run == "int8":
                # the same codes; XLA's compiled scale and dequantize round
                # an ulp apart from torch's in places
                scale = np.abs(_grads("dyadic", step)[n]).max()
                assert np.abs(synced[n] - want).max() <= 1e-6 * scale
                assert np.abs(ef[n] - ref[f"dyadic_{run}_{step}_ef_{n}"]) \
                    .max() <= 1e-6 * scale
            else:
                assert np.array_equal(synced[n], want)
            for d, out in enumerate(ranks):
                mine, mef, _, _ = out[("dyadic", run, step)]
                assert np.array_equal(mine[n], synced[n][d])
                if run == "int8":
                    assert np.array_equal(mef[n], ef[n][d])


@pytest.mark.parametrize("run", RUNS)
def test_gloo_ranks_log_and_tally(runs, run):
    ref, ranks = runs
    stacked = _stacked("random")
    n = {k: int(np.prod(s)) for k, s in SHAPES.items()}
    piece = {k: -(-v // LANES) for k, v in n.items()}
    for d, out in enumerate(ranks):
        for step in (0, 1):
            mine, mef, log, sent = out[("random", run, step)]
            assert log == list(ref[f"log_{run}"])
            for k in SHAPES:
                g = _grads("random", step)[k]
                assert np.abs(mine[k] - stacked[(run, step)][0][k][d]).max() \
                    <= TOL[run] * np.abs(g).max()
        _, _, _, sent = out[("random", run, 0)]
        if run == "flat":
            assert sent == {("world", "grad"): sum(n.values()) * (D - 1)}
            continue
        fast = 2 * sum(piece.values()) * (LANES - 1)     # RS + AG pieces
        if run == "nap3":
            assert sent == {("fast", "grad"): fast,
                            ("slow", "grad"): sum(piece.values()) * (N_PODS - 1)}
            # the slow group carries 1/|fast| of an all-reduce of the whole
            # gradient over it (up to the pads)
            whole = sum(n.values()) * (N_PODS - 1)
            assert sent[("slow", "grad")] * LANES >= whole
            assert sent[("slow", "grad")] * LANES < whole + LANES * len(n) * (N_PODS - 1)
        else:
            assert sent == {("fast", "grad"): fast,
                            ("slow", INT8_TAG): sum(piece.values()) * (N_PODS - 1),
                            ("slow", "grad"): len(n) * (N_PODS - 1)}


def test_init_error_feedback_shapes():
    g = {n: torch.zeros((D,) + s) for n, s in SHAPES.items()}
    ef = init_error_feedback(g, LANES)
    assert {n: tuple(t.shape) for n, t in ef.items()} == {
        "w": (D, 9), "b": (D, 1), "s": (D, 1), "blk": (D, 2)}
    with pytest.raises(ValueError, match="unknown strategy"):
        hier_grad_sync(g, N_PODS, LANES, "nap2", compress_slow=True)
