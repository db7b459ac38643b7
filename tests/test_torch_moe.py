"""The port's MoE block (``repro_torch.models.moe``) and the MoE LMs on the
CPU against the reference, on reduced ``mixtral-8x22b`` (8 experts, top-2,
sliding window) and ``qwen3-moe-235b-a22b`` (cut to 16 experts so its top-8
is a choice; qk-norm): the reference's parameters carried over by
``lm_params_from_arrays``, inputs drawn from numpy seeds.

- routing: the selected expert *sets* equal (``torch.topk`` and
  ``jax.lax.top_k`` may order the k slots differently), the dispatch
  positions equal and blind to the slot order;
- ``moe_ffn_tp`` at rtol/atol 1e-4 in float32 and 3e-2 of max|y| in
  bfloat16, at capacities that drop tokens and one that drops none;
- ``moe_ffn_ep`` on stacked ranks against the reference's ``moe_ffn_ep``
  inside ``shard_map`` (a JAX subprocess of this file on 8 host devices),
  NAP-3 and flat on 2×4 and 4×2 and one 8-rank axis, at 1e-4; ``nap`` on
  and off bit-equal, each logging two shuffles' signatures; EP against
  ``moe_ffn_tp`` where nothing drops; one process per rank (4 gloo ranks)
  against the stacked form;
- the model: parameters round-trip bit for bit, prefill logits at 1e-4,
  prefill + decode at ``capacity_factor=16`` at 1e-4 (as the reference's
  ``test_decode_matches_forward``), mixtral's ring cache past the window,
  ``Engine`` greedy tokens equal to the reference engine's.

The JAX EP side runs as a subprocess of this very file::

    python tests/test_torch_moe.py --jax-ref OUT.npz IN.npz
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

TOL = 1e-4
# bfloat16 over max|y|: both sides round the expert products and the
# combine to bfloat16 (8-bit mantissa, 4e-3 relative) at different places
BF16_TOL = 3e-2
ARCHS = {"mixtral-8x22b": {}, "qwen3-moe-235b-a22b": {"n_experts": 16}}
T_LOC = 16                     # tokens a rank in the EP cases
# (arch, mesh shape, nap): two axes ("pod", "lane") or one ("ep",)
EP_CASES = [(arch, mesh, nap) for arch in ARCHS
            for mesh, nap in (((2, 4), True), ((2, 4), False),
                              ((4, 2), True), ((8,), False))]
EP_CAPACITY = (1.25, 16.0)     # the reference's default drops; 16 drops none
TP_MESH = (4, 2)               # moe_ep_shardmap's ("data", "model") mesh


def _ep_id(case):
    arch, mesh, nap = case
    return f"{arch}-{'x'.join(map(str, mesh))}-{'nap' if nap else 'flat'}"


def _cfg(get_arch, arch, **kw):
    return dataclasses.replace(get_arch(arch).reduced(**ARCHS[arch]), **kw)


def _ep_inputs():
    """Each arch's layer-0 MoE weights from the reference's init and a
    ``[8 · T_LOC, d]`` token block."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jget_arch
    from repro.models.moe import moe_params as jmoe_params

    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(jget_arch, arch)
        p = jmoe_params(jax.random.PRNGKey(i), cfg, jnp.float32)
        for k, v in p.items():
            out[f"{arch}_{k}"] = np.asarray(v)
        out[f"{arch}_x"] = np.random.default_rng(i).standard_normal(
            (8 * T_LOC, cfg.d_model)).astype(np.float32)
    return out


# --------------------------------------------------------------- JAX side
def _jax_reference(out_path, in_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_arch as jget_arch
    from repro.core.compat import shard_map
    from repro.models.moe import moe_ffn_ep as jmoe_ffn_ep

    d = dict(np.load(in_path))
    out = {}
    for case in EP_CASES:
        arch, mesh_shape, nap = case
        names = ("pod", "lane") if len(mesh_shape) == 2 else ("ep",)
        mesh = jax.make_mesh(mesh_shape, names)
        spec = P(names if len(names) > 1 else names[0])
        for cf in EP_CAPACITY:
            cfg = _cfg(jget_arch, arch, capacity_factor=cf)

            def body(x, router, gate, up, down, cfg=cfg, names=names,
                     nap=nap):
                return jmoe_ffn_ep({"router": router, "gate": gate,
                                    "up": up, "down": down}, cfg, x,
                                   mesh_axes=names, nap=nap)

            f = jax.jit(shard_map(body, mesh=mesh,
                                  in_specs=(spec, P(), spec, spec, spec),
                                  out_specs=spec, check_vma=False))
            out[f"{_ep_id(case)}_{cf}"] = np.asarray(f(
                *(d[f"{arch}_{k}"] for k in ("x", "router", "gate", "up",
                                              "down"))))
    # moe_ep_shardmap: experts over "data" (4), d_ff over "model" (2), the
    # batch over "data"; Auto axes (jax.make_mesh's default Explicit ones
    # refuse the reference's sharding constraints under jax 0.9)
    from jax.sharding import AxisType

    from repro.models.moe import moe_ep_shardmap as jmoe_ep_shardmap
    tmesh = jax.make_mesh(TP_MESH, ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    for arch in ARCHS:
        cfg = _cfg(jget_arch, arch, capacity_factor=16.0)

        def f(x, router, gate, up, down, cfg=cfg):
            return jmoe_ep_shardmap({"router": router, "gate": gate,
                                     "up": up, "down": down}, cfg, x, tmesh,
                                    dp_axes=("data",), ep_axes=("data",),
                                    tp_axis="model")

        out[f"tp_{arch}"] = np.asarray(jax.jit(f)(
            d[f"{arch}_x"].reshape(8, T_LOC, -1),
            *(d[f"{arch}_{k}"] for k in ("router", "gate", "up", "down"))))
    np.savez(out_path, **out)


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "--jax-ref":
        sys.exit("usage: test_torch_moe.py --jax-ref OUT.npz IN.npz")
    _jax_reference(sys.argv[2], sys.argv[3])
    sys.exit(0)

# ------------------------------------------------------------- port side
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models.model import decode_step as jdecode_step  # noqa: E402
from repro.models.model import forward as jforward  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.models.moe import _dispatch_indices as jdispatch  # noqa: E402
from repro.models.moe import _route as jroute  # noqa: E402
from repro.models.moe import moe_ffn_tp as jmoe_ffn_tp  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import prefill_to_decode_cache as jprefill_to_decode  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_arrays, lm_params_to_arrays  # noqa: E402
from repro_torch.core.nap_collectives import all_to_all_signature  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.models.moe import (_dispatch_indices, _route,  # noqa: E402
                                    moe_ffn_ep, moe_ffn_tp)
from repro_torch.serve import Engine, Request, prefill_to_decode_cache  # noqa: E402


def _perturb(tree, rng):
    """Norm scales (ones) get noise, so qk-norm and the norms really act."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_perturb(v, rng) for v in tree)
    a = np.asarray(tree)
    if np.all(a == 0.0) or np.all(a == 1.0):
        a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
    return a


def _setup(arch, **kw):
    """(reference cfg, port cfg, reference params, port model on the CPU)."""
    jcfg, cfg = _cfg(jget_arch, arch, **kw), _cfg(get_arch, arch, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    arrays = _perturb(jax.tree.map(np.asarray,
                                   jinit_params(jcfg, jax.random.PRNGKey(0),
                                                jnp.float32)),
                      np.random.default_rng(0))
    model = init_lm(cfg, seed=1, dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_arrays(cfg, arrays), strict=True)
    return jcfg, cfg, jax.tree.map(jnp.asarray, arrays), model


def _layer_ffn(arrays, layer=0):
    """One layer's MoE weights out of the reference's stacked tree."""
    return {k: np.asarray(v[layer])
            for k, v in arrays["groups"][0]["ffn"].items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_route_selects_the_reference_expert_sets(arch):
    jcfg, cfg, jparams, _ = _setup(arch)
    router = _layer_ffn(jparams)["router"]
    x = np.random.default_rng(3).standard_normal((57, cfg.d_model)) \
        .astype(np.float32)
    jp, jsel = jroute(jnp.asarray(x), jnp.asarray(router), cfg.top_k)
    p, sel = _route(torch.from_numpy(x), torch.tensor(router), cfg.top_k)
    assert router.dtype == np.float32 and sel.shape == (57, cfg.top_k)
    for t in range(57):
        assert set(sel[t].tolist()) == set(np.asarray(jsel[t]).tolist()), t
    # the same probabilities, matched expert by expert
    got = np.zeros((57, cfg.n_experts))
    want = np.zeros((57, cfg.n_experts))
    np.put_along_axis(got, sel.numpy(), p.numpy(), axis=1)
    np.put_along_axis(want, np.asarray(jsel), np.asarray(jp), axis=1)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("capacity", [1, 3, 100])
def test_dispatch_positions_match_and_ignore_the_slot_order(capacity):
    """Random distinct selections: expert ids and positions equal the
    reference's; shuffling each token's k slots moves no (token, expert)
    position."""
    rng = np.random.default_rng(capacity)
    T, k, E = 40, 3, 7
    sel = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    je, jpos = jdispatch(jnp.asarray(sel, jnp.int32), E, capacity)
    e_id, pos = _dispatch_indices(torch.from_numpy(sel), E, capacity)
    assert np.array_equal(e_id.numpy(), np.asarray(je))
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    perm = np.stack([rng.permutation(k) for _ in range(T)])
    e2, pos2 = _dispatch_indices(
        torch.from_numpy(np.take_along_axis(sel, perm, 1)), E, capacity)
    before = {(t, int(e)): int(q) for t in range(T)
              for e, q in zip(e_id[t], pos[t])}
    after = {(t, int(e)): int(q) for t in range(T)
             for e, q in zip(e2[t], pos2[t])}
    assert before == after


# ------------------------------------------------------------- moe_ffn_tp
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 16.0])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_ffn_tp_matches_reference(arch, capacity_factor):
    jcfg, cfg, jparams, _ = _setup(arch, capacity_factor=capacity_factor)
    p = _layer_ffn(jparams)
    x = np.random.default_rng(4).standard_normal((3, 19, cfg.d_model)) \
        .astype(np.float32)
    want = jmoe_ffn_tp(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x))
    stats = {}
    got = moe_ffn_tp({k: torch.from_numpy(v) for k, v in p.items()}, cfg,
                     torch.from_numpy(x), stats)
    assert got.shape == x.shape
    _close(got, want)
    assert stats["selected"] == 3 * 19 * cfg.top_k
    assert (int(stats["dropped"]) > 0) == (capacity_factor < 16.0)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_ffn_tp_bfloat16_matches_reference(arch):
    """Experts and tokens in bfloat16, the router in float32 on both sides
    (the same bits: both round to nearest even)."""
    jcfg, cfg, jparams, _ = _setup(arch)
    p = _layer_ffn(jparams)
    x = np.random.default_rng(5).standard_normal((2, 23, cfg.d_model)) \
        .astype(np.float32)
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jnp.bfloat16)
          for k, v in p.items()}
    want = np.asarray(jmoe_ffn_tp(jp, jcfg, jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                     else torch.bfloat16)
          for k, v in p.items()}
    got = moe_ffn_tp(tp, cfg, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), err


# ------------------------------------------------------------- moe_ffn_ep
@pytest.fixture(scope="module")
def ep_ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ref")
    inputs = _ep_inputs()
    in_path, out_path = tmp / "in.npz", tmp / "out.npz"
    np.savez(in_path, **inputs)
    env = dict(os.environ)
    root = pathlib.Path(__file__).parents[1]
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, __file__, "--jax-ref", str(out_path), str(in_path)],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    return inputs, dict(np.load(out_path))


def _ep_operands(inputs, arch, D, dtype=torch.float32):
    """The stacked operands: x ``[D, T_LOC, d]``, slabs ``[D, e_loc, ...]``
    (rank r's experts are r·e_loc onward, as ``shard_map`` splits them)."""
    def t(k):
        return torch.from_numpy(inputs[f"{arch}_{k}"])
    p = {"router": t("router")}
    for k in ("gate", "up", "down"):
        w = t(k)
        p[k] = w.reshape((D, -1) + tuple(w.shape[1:])).to(dtype)
    x = t("x").reshape(D, T_LOC, -1).to(dtype)
    return p, x


@pytest.mark.parametrize("capacity_factor", EP_CAPACITY)
@pytest.mark.parametrize("case", EP_CASES, ids=[_ep_id(c) for c in EP_CASES])
def test_moe_ffn_ep_matches_reference_shard_map(ep_ref, case,
                                                 capacity_factor):
    inputs, ref = ep_ref
    arch, mesh, nap = case
    cfg = _cfg(get_arch, arch, capacity_factor=capacity_factor)
    p, x = _ep_operands(inputs, arch, 8)
    log = []
    got = moe_ffn_ep(p, cfg, x, mesh, nap=nap, log=log)
    strategy = "nap3" if len(mesh) == 2 and nap else "flat"
    assert log == 2 * list(all_to_all_signature(strategy))
    want = ref[f"{_ep_id(case)}_{capacity_factor}"]
    _close(got.reshape(want.shape), want)


@pytest.mark.parametrize("mesh", [(2, 4), (4, 2), (1, 8)])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_ffn_ep_nap3_is_bit_equal_to_flat(ep_ref, arch, mesh):
    p, x = _ep_operands(ep_ref[0], arch, 8)
    cfg = _cfg(get_arch, arch)
    flat = moe_ffn_ep(p, cfg, x, mesh, nap=False)
    assert torch.equal(moe_ffn_ep(p, cfg, x, mesh, nap=True), flat)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_ffn_ep_equals_tp_where_nothing_drops(ep_ref, arch, dtype, tol):
    """EP's capacity comes from T_loc, TP's from all tokens, so they drop
    different tokens; at ``capacity_factor=16`` neither drops any."""
    p, x = _ep_operands(ep_ref[0], arch, 8, dtype)
    cfg = _cfg(get_arch, arch, capacity_factor=16.0)
    ep = moe_ffn_ep(p, cfg, x, (2, 4), nap=True)
    full = {k: (v if k == "router" else v.reshape((-1,) + v.shape[2:]))
            for k, v in p.items()}
    stats = {}
    tp = moe_ffn_tp(full, cfg, x, stats)
    assert int(stats["dropped"]) == 0
    err = float((ep.float() - tp.float()).abs().max())
    if dtype == torch.float32:
        _close(ep, tp)
    else:
        assert err <= tol * float(tp.float().abs().max()), err


def _cotangent(shape):
    """A fixed cotangent for ``moe_ep_shardmap``'s output (the same on
    every rank)."""
    return torch.from_numpy(np.random.default_rng(7).standard_normal(
        tuple(shape)).astype(np.float32))


def _tp_rank(ranks, inputs):
    """One gloo rank of ``moe_ep_shardmap`` on a (4, 2) ("data", "model")
    mesh (runs in the spawned processes): the arch's weights and tokens as
    DTensors, experts over "data", d_ff over "model", the batch over
    "data"."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.act_sharding import (activation_sharding,
                                                 placements_of)
    from repro_torch.models.moe import moe_ep_shardmap

    mesh = make_mesh(TP_MESH, ("data", "model"), device_type="cpu",
                     fake=False)
    specs = {"router": (), "gate": ("data", None, "model"),
             "up": ("data", None, "model"), "down": ("data", "model", None)}
    out = {}
    for arch in ARCHS:
        cfg = _cfg(get_arch, arch, capacity_factor=16.0)
        p = {k: distribute_tensor(torch.from_numpy(inputs[f"{arch}_{k}"]),
                                  mesh, placements_of(mesh, spec))
             for k, spec in specs.items()}
        x = distribute_tensor(
            torch.from_numpy(inputs[f"{arch}_x"]).reshape(8, T_LOC, -1), mesh,
            placements_of(mesh, ("data", None, None)))
        y = moe_ep_shardmap(p, cfg, x, mesh, dp_axes=("data",),
                            ep_axes=("data",), tp_axis="model")
        out[arch] = y.full_tensor().numpy()
        # the gradients of <y, cot> for every operand, gathered whole
        leaves = {k: v.detach().requires_grad_()
                  for k, v in dict(p, x=x).items()}
        y = moe_ep_shardmap(leaves, cfg, leaves["x"], mesh,
                            dp_axes=("data",), ep_axes=("data",),
                            tp_axis="model")
        cot = distribute_tensor(_cotangent(y.shape), mesh, y.placements)
        (y * cot).sum().full_tensor().backward()
        out[f"grad_{arch}"] = {k: v.grad.full_tensor().numpy()
                               for k, v in leaves.items()}
        # the TP regime on DTensors (the reference's GSPMD path): d_model
        # over "data" (FSDP), d_ff over "model", the dispatch buffer's
        # capacity over "data"
        tp = {k: distribute_tensor(torch.from_numpy(inputs[f"{arch}_{k}"]),
                                   mesh, placements_of(mesh, spec))
              for k, spec in (("router", ()),
                              ("gate", (None, "data", "model")),
                              ("up", (None, "data", "model")),
                              ("down", (None, "model", "data")))}
        with activation_sharding(moe_buf_spec=(None, "data", "model")):
            y = moe_ffn_tp(tp, cfg, x)
        out[f"tp_{arch}"] = y.full_tensor().numpy()
    return out if ranks.rank == 0 else None


def test_moe_ffn_ep_refuses_what_is_not_ported(ep_ref):
    """``moe_ffn_ep`` with d_ff over a TP group runs: ``moe_ep_shardmap``
    (a ``local_map`` around it, the shuffles between the ranks of the EP
    group, the down projection summed over the TP group) on 8 gloo ranks
    against the reference's ``moe_ep_shardmap`` on 8 host devices, at 1e-4;
    its gradients (the router's summed over the token shards, the slabs'
    input's over the TP group) against the one-device ``moe_ffn_tp``'s
    (nothing drops), at 1e-4 of each one's max.  ``moe_ffn_tp`` on DTensors (the TP regime: FSDP and d_ff sharded
    weights, the capacity dim over "data") against the one-device
    ``moe_ffn_tp``, at 1e-4.  What stays refused: a TP group without one
    process per rank, three mesh axes, and ranks of another grid."""
    from repro_torch.launch.ranks import spawn

    inputs, ref = ep_ref
    got = spawn(_tp_rank, 2, 4, (inputs,), deadline=180.0)[0]
    for arch in ARCHS:
        _close(torch.from_numpy(got[arch]), ref[f"tp_{arch}"])
        # moe_ffn_tp on DTensors against the one-device moe_ffn_tp
        cfg = _cfg(get_arch, arch, capacity_factor=16.0)
        want = moe_ffn_tp({k: torch.from_numpy(inputs[f"{arch}_{k}"])
                           for k in ("router", "gate", "up", "down")}, cfg,
                          torch.from_numpy(inputs[f"{arch}_x"]).reshape(
                              8, T_LOC, -1))
        _close(torch.from_numpy(got[f"tp_{arch}"]), want.numpy())
        leaves = {k: torch.from_numpy(inputs[f"{arch}_{k}"]).requires_grad_()
                  for k in ("router", "gate", "up", "down")}
        leaves["x"] = torch.from_numpy(inputs[f"{arch}_x"]).reshape(
            8, T_LOC, -1).requires_grad_()
        y = moe_ffn_tp(leaves, cfg, leaves["x"])
        (y * _cotangent(y.shape)).sum().backward()
        for k, v in leaves.items():
            want = v.grad.numpy()
            err = float(np.abs(got[f"grad_{arch}"][k] - want).max())
            assert err <= TOL * float(np.abs(want).max()), (arch, k, err)
    cfg = _cfg(get_arch, "mixtral-8x22b")
    x = torch.zeros(8, 4, cfg.d_model)
    with pytest.raises(ValueError, match="needs ranks="):
        moe_ffn_ep({}, cfg, x, (2, 4), tp_axis="model")
    with pytest.raises(ValueError, match="3 axes"):
        moe_ffn_ep({}, cfg, x, (2, 2, 2))
    other_grid = types.SimpleNamespace(size=8, n_pods=4, lanes=2)
    with pytest.raises(ValueError, match="4 x 2 grid"):
        moe_ffn_ep({}, cfg, x[:1], (2, 4), ranks=other_grid)


def _ep_rank(ranks, inputs):
    """One gloo rank of a 2×2 EP run (runs in the spawned processes)."""
    cfg = _cfg(get_arch, "qwen3-moe-235b-a22b")
    p, x = _ep_operands(inputs, "qwen3-moe-235b-a22b", 4)
    d = ranks.rank
    out = {}
    for nap in (True, False):
        log = []
        mine = moe_ffn_ep({k: (v if k == "router" else v[d:d + 1])
                           for k, v in p.items()}, cfg, x[d:d + 1], (2, 2),
                          nap=nap, log=log, ranks=ranks)
        out[nap] = (mine[0].numpy(),
                    moe_ffn_ep(p, cfg, x, (2, 2), nap=nap)[d].numpy(), log)
    return out


def test_moe_ffn_ep_on_process_ranks_matches_stacked(ep_ref):
    from repro_torch.launch.ranks import spawn

    inputs = {k: v[: 4 * T_LOC] if k.endswith("_x") else v
              for k, v in ep_ref[0].items()}
    outs = spawn(_ep_rank, 2, 2, (inputs,), deadline=120.0)
    for nap, strategy in ((True, "nap3"), (False, "flat")):
        for mine, stacked, log in (o[nap] for o in outs):
            assert log == 2 * list(all_to_all_signature(strategy))
            # the same code per rank: only the batched products' blocking
            # may differ from the stacked run's
            np.testing.assert_allclose(mine, stacked, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_params_round_trip(arch):
    jcfg, cfg, jparams, model = _setup(arch)
    state = model.state_dict()
    assert {"layers.0.ffn.router", "layers.1.ffn.down"} <= set(state)
    assert state["layers.0.ffn.router"].dtype == torch.float32
    back = lm_params_to_arrays(cfg, state)
    want = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_reference(arch):
    jcfg, cfg, jparams, model = _setup(arch)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 37),
                                               dtype=np.int32)
    want, (jcaches, _) = jforward(jparams, jcfg, jnp.asarray(tokens),
                                  use_kernel=True, return_cache=True)
    with torch.inference_mode():
        got, ((caches,), _) = model(torch.from_numpy(tokens),
                                    return_cache=True)
    assert got.shape == (2, 37, cfg.vocab)
    _close(got, want)
    for name in ("k", "v"):
        _close(caches[name], jcaches[0][name])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_then_decode_matches_reference(arch):
    """At ``capacity_factor=16`` (no drops), so decode also reproduces the
    full forward, as in the reference's ``test_decode_matches_forward``."""
    jcfg, cfg, jparams, model = _setup(arch, capacity_factor=16.0)
    rng = np.random.default_rng(3)
    S, ctx, n = 21, 32, 4
    tokens = rng.integers(0, cfg.vocab, (2, S + n), dtype=np.int32)
    jlogits, jc = jforward(jparams, jcfg, jnp.asarray(tokens[:, :S]),
                           use_kernel=True, return_cache=True)
    jcache = jprefill_to_decode(jcfg, jc, ctx, S)
    model.moe_stats = {}
    with torch.inference_mode():
        full = model(torch.from_numpy(tokens))
        logits, c = model(torch.from_numpy(tokens[:, :S]), return_cache=True)
        cache = prefill_to_decode_cache(cfg, c, ctx, S)
        _close(logits[:, -1], jlogits[:, -1])
        for t in range(n):
            step = tokens[:, S + t:S + t + 1]
            jl, jcache = jdecode_step(jparams, jcfg, jnp.asarray(step),
                                      jcache, jnp.int32(S + t))
            lg, cache = model.decode_step(torch.from_numpy(step), cache,
                                          S + t)
            _close(lg, jl)
            if t + 1 < n:
                _close(lg, full[:, S + t])
    stats = model.moe_stats
    assert stats["selected"] == cfg.n_layers * n * 2 * cfg.top_k
    assert int(stats["dropped"]) == 0


def test_sliding_window_ring_cache_past_the_window():
    """mixtral's reduced window (32): a prefill of 28, then 12 decode steps
    to 8 past the window, the ring evicting, against the reference's decode
    and the port's own forward."""
    jcfg, cfg, jparams, model = _setup("mixtral-8x22b", capacity_factor=16.0)
    assert cfg.window == 32
    S, S0 = cfg.window + 8, cfg.window - 4
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, (1, S),
                                                dtype=np.int32)
    jstep = jax.jit(jdecode_step, static_argnums=1)
    with torch.inference_mode():
        full = model(torch.from_numpy(tokens))
        _, c = model(torch.from_numpy(tokens[:, :S0]), return_cache=True)
        cache = prefill_to_decode_cache(cfg, c, S, S0)
        _, jc = jforward(jparams, jcfg, jnp.asarray(tokens[:, :S0]),
                         return_cache=True)
        jcache = jprefill_to_decode(jcfg, jc, S, S0)
        for t in range(S0, S):
            step = tokens[:, t:t + 1]
            lg, cache = model.decode_step(torch.from_numpy(step), cache, t)
            jl, jcache = jstep(jparams, jcfg, jnp.asarray(step), jcache,
                               jnp.int32(t))
    assert cache[0][0]["k"].shape[2] == cfg.window
    _close(lg, jl)
    _close(lg, full[:, -1])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_engine_greedy_tokens_match_reference(arch):
    """Mixed prompt lengths in batches of 3 + 2, left-padded with token 0,
    at the default capacity: padded positions count in T on both sides, and
    decode at batch 3 drops what the reference drops."""
    jcfg, cfg, jparams, model = _setup(arch)
    lengths = [10, 4, 13, 7, 9]

    def reqs(cls):
        rng = np.random.default_rng(0)
        return [cls(rid=i, prompt=rng.integers(0, cfg.vocab, n,
                                               dtype=np.int32),
                    max_new_tokens=5) for i, n in enumerate(lengths)]

    jeng = JEngine(jcfg, jparams, max_batch=3, ctx_len=64)
    for r in reqs(JRequest):
        jeng.submit(r)
    want = jeng.run()
    eng = Engine(cfg, model, max_batch=3, ctx_len=64, device="cpu")
    for r in reqs(Request):
        eng.submit(r)
    got = eng.run()
    assert sorted(got) == list(range(5)) and eng.stats["batches"] == 2
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
