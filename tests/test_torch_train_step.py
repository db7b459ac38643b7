"""The port's training step on the CPU against the reference, for every
arch in ``ARCHS`` at ``reduced()`` (dense, MoE, recurrent, embedding-input),
float32, the same parameters carried over by ``lm_params_from_arrays``:

- ``loss_fn`` and its gradients against ``jax.value_and_grad``: loss at
  1e-5 relative, each gradient leaf at 1e-4 of its max|g| (two BLAS
  libraries summing in other orders; the recurrent blocks' backward runs
  through sequential loops whose sums they also order differently);
- three train steps (``make_step_fn``: loss, gradients, clipping, AdamW;
  lr warms up over 2 steps, then the cosine) against the reference's
  ``loss_fn`` gradients through its ``adamw_update``, jitted (its
  ``make_step_fn`` itself in the decay test): loss at 1e-5 relative, grad_norm at 1e-5, lr at 1e-6, m and v
  leaves at 1e-4 of their max; the parameters in units of lr, 0.25: a step
  moves an element by about lr·m/sqrt(v), which for an element whose
  gradient is near zero is a ratio of two small numbers, so the two
  packages' rounding moves it by a share of lr (0.1 lr at most seen, in
  mixtral's MoE);
- the decay rule on the reference's stacked shapes (a grouped layer's norm
  scale decays, a remainder layer's and ``final_norm`` do not), shown by
  recurrentgemma at 5 layers (one group of 3, 2 remainder layers);
- microbatches 2 against 1, remat against none, ``loss_chunk`` against the
  full loss (the port against itself: 1e-6 for loss, 1e-5 of max for m);
  an MoE arch's microbatches against the reference's step with the same
  microbatches (each routes with its own capacity), at the same bars; the
  donated step (moments updated in place) bit-equal to the plain one;
- the refusal of ``use_kernel=True`` (the kernel has no backward), and a
  ZeRO-2 step through ``build_train_step(mesh=)`` on 8 gloo ranks against
  the one-device step (:func:`assert_step_matches`: loss and grad_norm at
  1e-5, m and v at 1e-4 of their max, the parameters at 0.01 lr where the
  gradient stands clear of its rounding).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.models.model import loss_fn as jloss_fn  # noqa: E402
from repro.train.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train.optimizer import adamw_update as jadamw_update  # noqa: E402
from repro.train.optimizer import init_opt_state as jinit_opt  # noqa: E402
from repro.train.train_step import TrainOptions as JTrainOptions  # noqa: E402
from repro.train.train_step import make_step_fn as jmake_step_fn  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_arrays, lm_params_to_arrays  # noqa: E402
from repro_torch.models.model import init_lm, loss_fn  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig, decay_mask,  # noqa: E402
                                         init_opt_state, schedule)
from repro_torch.train.train_step import (TrainOptions, build_train_step,  # noqa: E402
                                          make_step_fn)

ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=10)
LOSS_RTOL, GRAD_TOL, MOMENT_TOL, PARAM_TOL_LR = 1e-5, 1e-4, 1e-4, 0.25


def _setup(arch, **reduce):
    jcfg = jget_arch(arch).reduced(**reduce)
    cfg = get_arch(arch).reduced(**reduce)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    arrays = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0),
                                                   jnp.float32))
    model = init_lm(cfg, seed=1, dtype=torch.float32, device="cpu",
                    trainable=True)
    model.load_state_dict(lm_params_from_arrays(cfg, arrays), strict=True)
    return jcfg, cfg, jax.tree.map(jnp.asarray, arrays), model


def _batch(cfg, rng, B=2, S=16):
    if cfg.embed_input:
        inputs = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    else:
        inputs = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return {"inputs": inputs,
            "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _tree(cfg, named):
    return lm_params_to_arrays(cfg, {n: t.detach() for n, t in named.items()})


def _leaf_errs(got_tree, want_tree):
    """Per leaf: max|got - want| and max|want|."""
    assert jax.tree.structure(got_tree) == jax.tree.structure(
        jax.tree.map(np.asarray, want_tree))
    return [(float(np.abs(a - np.asarray(b)).max()),
             float(np.abs(np.asarray(b)).max()))
            for a, b in zip(jax.tree.leaves(got_tree), jax.tree.leaves(want_tree))]


def _jref_step(jcfg):
    """The reference's loss, gradients and ``adamw_update`` in one jitted
    function (its ``make_step_fn`` at one microbatch, with the gradients
    returned too): one compile a config."""
    acfg = JAdamWConfig(**ADAMW)

    def step(params, opt, batch):
        loss, grads = jax.value_and_grad(jloss_fn)(params, jcfg, batch)
        params, opt, om = jadamw_update(acfg, params, grads, opt)
        return params, opt, {"loss": loss, **om}, grads

    return jax.jit(step)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_grads_and_adamw_steps_match_reference(arch):
    jcfg, cfg, jparams, model = _setup(arch)
    rng = np.random.default_rng(0)
    batches = [_batch(cfg, rng) for _ in range(3)]
    jstep = _jref_step(jcfg)
    step = make_step_fn(cfg, AdamWConfig(**ADAMW), TrainOptions(remat=False))
    jopt = jinit_opt(jparams)
    opt = init_opt_state(dict(model.named_parameters()))
    for i, batch in enumerate(batches):
        params = dict(model.named_parameters())
        loss = loss_fn(model, cfg, _tensors(batch))
        grads = torch.autograd.grad(loss, list(params.values()))
        jparams, jopt, jm, jg = jstep(jparams, jopt,
                                      jax.tree.map(jnp.asarray, batch))
        # loss_fn and its gradients at the parameters both sides hold
        assert abs(float(loss) - float(jm["loss"])) \
            <= LOSS_RTOL * abs(float(jm["loss"]))
        if i == 0:     # same parameters: each gradient leaf against jax's
            for err, scale in _leaf_errs(_tree(cfg, dict(zip(params, grads))),
                                         jg):
                assert err <= GRAD_TOL * scale, (err, scale)
        model, opt, m = step(model, opt, _tensors(batch))
        lr = float(jm["lr"])
        assert abs(m["lr"] - lr) <= 1e-6 * lr
        assert abs(float(m["loss"]) - float(jm["loss"])) \
            <= LOSS_RTOL * abs(float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-5 * float(jm["grad_norm"])
        assert int(opt["count"]) == int(jopt["count"]) == i + 1
        for key in ("m", "v"):
            for err, scale in _leaf_errs(_tree(cfg, opt[key]), jopt[key]):
                assert err <= MOMENT_TOL * scale, (key, err, scale)
        for err, _ in _leaf_errs(_tree(cfg, dict(model.named_parameters())),
                                 jparams):
            assert err <= PARAM_TOL_LR * lr, err / lr


def test_decay_follows_the_reference_stacked_shapes():
    """recurrentgemma at 5 layers: pattern (rglru, rglru, attn) once, then 2
    remainder layers.  The decay mask equals the reference's ``ndim >= 2``
    on its own arrays, and one step leaves exactly the undecayed norm scales
    where the reference's step leaves them."""
    jcfg, cfg, jparams, model = _setup("recurrentgemma-9b", n_layers=5)
    params = dict(model.named_parameters())
    mask = decay_mask(cfg, params)
    want = lm_params_from_arrays(cfg, jax.tree.map(
        lambda a: np.full(a.shape, a.ndim >= 2), jparams))
    assert set(mask) == set(want)
    for name, flag in mask.items():
        assert bool(want[name].all()) == flag == bool(want[name].any()), name
    assert mask["layers.0.ln1.scale"] and mask["layers.2.ln2.scale"]
    assert not mask["layers.3.ln1.scale"] and not mask["layers.4.ln1.scale"]
    assert not mask["final_norm.scale"] and mask["lm_head"]
    assert mask["layers.0.core.lam"]           # stacked [1, d]: decays
    # one step against the reference's, on a norm-heavy comparison
    batch = _batch(cfg, np.random.default_rng(1))
    jnew, _, jm = jax.jit(jmake_step_fn(
        jcfg, JAdamWConfig(**ADAMW), JTrainOptions(remat=False)))(
        jparams, jinit_opt(jparams), jax.tree.map(jnp.asarray, batch))
    step = make_step_fn(cfg, AdamWConfig(**ADAMW), TrainOptions(remat=False))
    model, _, _ = step(model, init_opt_state(params), _tensors(batch))
    got = _tree(cfg, dict(model.named_parameters()))
    for err, _ in _leaf_errs(got, jnew):
        assert err <= PARAM_TOL_LR * float(jm["lr"])


def test_schedule_matches_reference():
    from repro.train.optimizer import schedule as jschedule

    for cfg in (AdamWConfig(**ADAMW), AdamWConfig()):
        jcfg = JAdamWConfig(**dataclasses.asdict(cfg))
        for s in (0, 1, 2, 3, 50, 99, 100, 101, 5000, 10000, 20000):
            want = float(jschedule(jcfg, s))
            assert abs(schedule(cfg, s) - want) <= 1e-6 * max(want, 1e-12)


def _one_step(model, cfg, batch, **opts):
    step = make_step_fn(cfg, AdamWConfig(**ADAMW), TrainOptions(**opts))
    opt = init_opt_state(dict(model.named_parameters()))
    _, opt, m = step(model, opt, _tensors(batch))
    return float(m["loss"]), opt


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "xlstm-125m",
                                  "phi-3-vision-4.2b", "mixtral-8x22b",
                                  "qwen3-moe-235b-a22b", "recurrentgemma-9b"])
@pytest.mark.parametrize("variant", [dict(microbatches=2), dict(remat=True),
                                     dict(loss_chunk=4)])
def test_step_variants_equal_the_plain_step(arch, variant):
    jcfg, cfg, jparams, model = _setup(arch)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _batch(cfg, np.random.default_rng(2), B=4)
    if cfg.is_moe and variant.get("microbatches", 1) > 1:
        # each microbatch routes with its own capacity (from its T / mb
        # tokens), as the reference's scan over microbatches does, so a
        # token the whole batch drops may be kept in a split: the step to
        # equal is the reference's own with the same microbatches
        jnew, jopt, jm = jax.jit(jmake_step_fn(
            jcfg, JAdamWConfig(**ADAMW), JTrainOptions(remat=False, **variant)))(
            jparams, jinit_opt(jparams), jax.tree.map(jnp.asarray, batch))
        base_loss = float(jm["loss"])
        base = {k: lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jopt[k]))
                for k in ("m", "v")}
    else:
        base_loss, base = _one_step(model, cfg, batch, remat=False)
    model.load_state_dict(state)
    loss, opt = _one_step(model, cfg, batch, **{"remat": False, **variant})
    assert abs(loss - base_loss) <= 1e-6 * abs(base_loss)
    for key in ("m", "v"):
        for name, t in opt[key].items():
            want = base[key][name]
            assert float((t - want).abs().max()) <= \
                1e-5 * float(want.abs().max()), (key, name)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x22b",
                                  "recurrentgemma-9b"])
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_donated_step_is_the_plain_step_bit_for_bit(arch, moments):
    """``make_step_fn(donate=True)`` over three steps: the same loss, grad
    norm, parameters and moments, bit for bit, the moments updated in the
    very tensors passed in (bfloat16 ones too: the update runs in float32
    and is copied back)."""
    _, cfg, _, model = _setup(arch)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(5)
    batches = [_tensors(_batch(cfg, rng)) for _ in range(3)]
    runs = []
    for donate in (False, True):
        model.load_state_dict(state)
        opt = init_opt_state(dict(model.named_parameters()), moment_dtype=moments)
        given = opt["m"]["final_norm.scale"]
        step = make_step_fn(cfg, AdamWConfig(**ADAMW), TrainOptions(remat=False),
                            donate=donate)
        for batch in batches:
            model, opt, m = step(model, opt, batch)
        assert (opt["m"]["final_norm.scale"] is given) == donate
        runs.append((m, {n: p.detach().clone() for n, p in model.named_parameters()},
                     opt))
    (ma, pa, oa), (mb, pb, ob) = runs
    assert float(ma["loss"]) == float(mb["loss"])
    assert float(ma["grad_norm"]) == float(mb["grad_norm"])
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
        for k in ("m", "v"):
            assert torch.equal(oa[k][n], ob[k][n]), (k, n)


def test_masked_loss_matches_reference():
    jcfg, cfg, jparams, model = _setup("qwen2-0.5b")
    batch = _batch(cfg, np.random.default_rng(3))
    batch["mask"] = (np.random.default_rng(4).random((2, 16)) > 0.3) \
        .astype(np.float32)
    want = float(jloss_fn(jparams, jcfg, jax.tree.map(jnp.asarray, batch)))
    with torch.no_grad():
        got = float(loss_fn(model, cfg, _tensors(batch)))
        chunked = float(loss_fn(model, cfg, _tensors(batch), loss_chunk=8))
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    assert abs(chunked - want) <= LOSS_RTOL * abs(want)
    with pytest.raises(ValueError, match="must divide"):
        loss_fn(model, cfg, _tensors(batch), loss_chunk=5)


def _zero2_rank(ranks, cfg, inp, tgt):
    """One gloo rank of a ZeRO-2 step through ``build_train_step(mesh=)``
    on a (2, 2, 2) mesh (runs in the spawned processes)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import shard_state

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu",
                     fake=False)
    model = init_lm(cfg, 0, torch.float32, "cpu", trainable=True)
    opts = TrainOptions(remat=False, microbatches=2, dp_axes=("pod", "data"),
                        zero2=True)
    step, (p_sh, o_sh, b_sh) = build_train_step(
        cfg, AdamWConfig(**ADAMW), opts, mesh=mesh,
        params_shape=dict(model.named_parameters()))
    opt = shard_state(model, init_opt_state(dict(model.named_parameters())),
                      mesh, p_sh, o_sh)
    batch = {"inputs": distribute_tensor(torch.as_tensor(inp), mesh,
                                         b_sh["inputs"]),
             "targets": distribute_tensor(torch.as_tensor(tgt), mesh,
                                          b_sh["targets"])}
    _, opt, om = step(model, opt, batch)
    sharded = sum(1 for pl in o_sh["m"].values()
                  if any(p.is_shard() for p in pl))

    def whole(t):                                  # every rank gathers
        return t.full_tensor().detach().numpy()

    out = {"params": {n: whole(p) for n, p in model.named_parameters()},
           "m": {n: whole(t) for n, t in opt["m"].items()},
           "v": {n: whole(t) for n, t in opt["v"].items()},
           "grad_norm": float(om["grad_norm"])}
    loss = om["loss"]
    out["loss"] = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                        else loss)
    return (out, sharded) if ranks.rank == 0 else None


def assert_step_matches(got: dict, model, opt: dict, om: dict, lr: float):
    """A sharded step's gathered state (``got``: loss, grad_norm, and the
    parameters and AdamW moments by name) against the one-device step's
    (``model`` after it, its ``opt`` state and metrics ``om``): loss and
    grad_norm at 1e-5 relative; m = (1 - b1)·g, so m gives the clipped
    gradient itself, held at ``MOMENT_TOL`` of its leaf's max, and v at the
    same; the parameters at 0.01 lr (1e-4 lr seen) wherever the gradient
    stands clear of its rounding (|g| above ``GRAD_TOL`` of its leaf's
    max).  Below that the first step moves an
    element by lr·g/(|g| + eps), whose sign the order of the sums decides
    (0.03 lr seen); the moments hold those elements."""
    assert abs(got["loss"] - float(om["loss"])) <= \
        LOSS_RTOL * abs(float(om["loss"]))
    gnorm = float(om["grad_norm"])
    assert abs(got["grad_norm"] - gnorm) <= 1e-5 * gnorm, \
        (got["grad_norm"], gnorm)
    for key in ("m", "v"):
        for n, t in opt[key].items():
            want = t.detach().numpy()
            scale = float(np.abs(want).max())
            assert scale > 0, (key, n)
            err = float(np.abs(got[key][n] - want).max())
            assert err <= MOMENT_TOL * scale, (key, n, err / scale)
    for n, p in model.named_parameters():
        g = np.abs(opt["m"][n].detach().numpy())
        clear = g > GRAD_TOL * g.max()
        err = np.abs(got["params"][n] - p.detach().numpy())[clear]
        assert err.max() <= 0.01 * lr, (n, err.max() / lr)


def test_refusals():
    """The flash kernel still refuses to train (no backward); ZeRO-2 and a
    mesh run: on 8 gloo ranks the ZeRO-2 step through
    ``build_train_step(mesh=)`` equals the plain one-device step
    (:func:`assert_step_matches`: loss, grad_norm, both moments and the
    parameters)."""
    from repro_torch.launch.ranks import spawn
    from repro_torch.train.optimizer import init_opt_state, schedule

    _, cfg, _, model = _setup("qwen3-1.7b")
    acfg = AdamWConfig(**ADAMW)
    with pytest.raises(NotImplementedError, match="no backward"):
        make_step_fn(cfg, acfg, TrainOptions(use_kernel=True))
    # the forward through the kernel refuses to differentiate
    batch = _tensors(_batch(cfg, np.random.default_rng(5)))
    with pytest.raises(NotImplementedError, match="no backward"):
        loss_fn(model, cfg, batch, use_kernel=True)
    step, sh = build_train_step(cfg, acfg, TrainOptions())
    assert sh is None and callable(step)
    with pytest.raises(ValueError, match="params_shape"):
        build_train_step(cfg, acfg, TrainOptions(), mesh=object())
    rng = np.random.default_rng(6)
    inp = rng.integers(0, cfg.vocab, (8, 16))
    tgt = rng.integers(0, cfg.vocab, (8, 16))
    got, n_sharded = spawn(_zero2_rank, 2, 4, (cfg, inp, tgt))[0]
    assert n_sharded > 0
    one = init_lm(cfg, 0, torch.float32, "cpu", trainable=True)
    plain = make_step_fn(cfg, acfg, TrainOptions(remat=False, microbatches=2,
                                                 zero2=True))
    _, opt, om = plain(one, init_opt_state(dict(one.named_parameters())),
                       {"inputs": torch.as_tensor(inp),
                        "targets": torch.as_tensor(tgt)})
    assert_step_matches(got, one, opt, om, schedule(acfg, 1))
