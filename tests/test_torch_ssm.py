"""The port's recurrent blocks and the recurrent archs on the CPU against the
reference, with inputs made by numpy from a seed and the reference's
weights carried across (by ``lm_params_from_arrays`` for whole models):

- each block's forward (``mlstm_forward``, ``slstm_forward``,
  ``rglru_forward``) at S = 17, 256 and 300 (300 crosses mLSTM's 256-step
  chunk and pads): float32 within 1e-5 of max|y|, bfloat16 within 3e-2;
- each block's returned state against the reference's, mLSTM's pad decay
  included, and that decay itself on both sides (the state of a 300-step
  prefill against 300 decode steps);
- each block's decode step from a carried state, and RG-LRU's forward from
  one;
- reduced xlstm-125m (14 layers: 2 groups of its 6-block pattern and 2
  remainder blocks) and recurrentgemma-9b (5 layers: one group and 2
  remainder blocks): logits against the reference's ``forward``, prefill
  then 4 decode steps against ``decode_step`` (1e-4 of max|logits|),
  ``prefill_to_decode_cache`` and ``init_cache`` in the reference's
  layout, bfloat16 logits, ``Engine`` greedy tokens against the
  reference's engine, a parameter round trip through ``convert.py``, and
  the launcher;
- the plain flash attention at head dim 256 (recurrentgemma-9b's), causal
  and windowed, MQA, against the reference's Pallas kernel in interpret
  mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jflash  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import decode_step as jdecode_step  # noqa: E402
from repro.models.model import forward as jforward  # noqa: E402
from repro.models.model import init_cache as jinit_cache  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import prefill_to_decode_cache as jprefill_to_decode  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_arrays, lm_params_to_arrays  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import LM, init_cache, init_lm, ssm  # noqa: E402
from repro_torch.serve import Engine, Request, prefill_to_decode_cache  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}   # over max|y|
LOGITS_TOL = 1e-4                                      # over max|logits|
# bfloat16 logits over max|logits|: both sides round the same bfloat16
# weights' activations to bfloat16 at different places (the reason at
# tests/test_torch_lm_serve.py's BF16_TOL).  Where the arch itself carries
# bfloat16's roundings further (at d_model 64 each of xlstm's first mLSTM
# layers doubles the error of its input: the reference's own bfloat16
# logits lie 0.15 of max|logits| from its float32 ones), the two sides may
# be as far apart as the reference is from itself, and no further
BF16_TOL = 3e-2
KINDS = ("mlstm", "slstm", "rglru")
SEQ = (17, 256, 300)
ARCHS = {"xlstm-125m": dict(n_layers=14, d_model=64, n_heads=4, vocab=128),
         "recurrentgemma-9b": dict(n_layers=5, d_model=64, n_heads=4, vocab=128)}
JPARAMS = {"mlstm": jssm.mlstm_params, "slstm": jssm.slstm_params,
           "rglru": jssm.rglru_params}
JFORWARD = {"mlstm": jssm.mlstm_forward, "slstm": jssm.slstm_forward,
            "rglru": jssm.rglru_forward}
JDECODE = {"mlstm": jssm.mlstm_decode, "slstm": jssm.slstm_decode,
           "rglru": jssm.rglru_decode}
FORWARD = {"mlstm": ssm.mlstm_forward, "slstm": ssm.slstm_forward,
           "rglru": ssm.rglru_forward}
DECODE = {"mlstm": ssm.mlstm_decode, "slstm": ssm.slstm_decode,
          "rglru": ssm.rglru_decode}


def _cfg(kind):
    arch = "recurrentgemma-9b" if kind == "rglru" else "xlstm-125m"
    return get_arch(arch).reduced(d_model=64, n_heads=4)


def _block(kind, seed=0):
    """The reference's parameters of one block as numpy float32, with the
    constant leaves (biases, ``lam``, ``f_bias``) perturbed so they act."""
    cfg = _cfg(kind)
    p = {k: np.array(v) for k, v in
         JPARAMS[kind](jax.random.PRNGKey(seed), cfg, jnp.float32).items()}
    rng = np.random.default_rng(seed)
    for name in ("bias", "lam", "f_bias"):
        if name in p:
            p[name] = p[name] + 0.3 * rng.standard_normal(p[name].shape).astype(np.float32)
    return cfg, p


def _sides(p, dtype):
    """(reference params in ``dtype``, port params in ``dtype``): the same
    bfloat16 values on both sides (both round to nearest even); ``lam``
    stays float32, as both packages keep it."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = {k: jnp.asarray(v) if k == "lam" else jnp.asarray(v).astype(jdt)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(v) if k == "lam" else torch.from_numpy(v).to(dtype)
          for k, v in p.items()}
    return jp, tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _leaves(state):
    """A block's state as a flat list, in the reference's order."""
    if isinstance(state, dict):
        return [state["conv"], state["h"]]
    return list(state)


def _x(cfg, S, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return jx, torch.from_numpy(x).to(dtype)


# ----------------------------------------------------------------- blocks
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("S", SEQ)
@pytest.mark.parametrize("kind", KINDS)
def test_block_forward_and_state_match_reference(kind, S, dtype):
    cfg, p = _block(kind)
    jp, tp = _sides(p, dtype)
    jx, tx = _x(cfg, S, dtype, seed=S)
    want, wstate = JFORWARD[kind](jp, cfg, jx)
    with torch.inference_mode():
        got, state = FORWARD[kind](tp, cfg, tx)
    assert got.dtype == dtype
    assert _rel(got, want) <= TOL[dtype]
    for g, w in zip(_leaves(state), _leaves(wstate), strict=True):
        assert g.dtype == torch.float32
        assert _rel(g, w) <= TOL[dtype]


@pytest.mark.parametrize("kind", KINDS)
def test_block_decode_from_a_carried_state(kind):
    """One decode step from the same state (the reference's after 17
    steps) on both sides, then three more: outputs and states."""
    cfg, p = _block(kind, seed=1)
    jp, tp = _sides(p, torch.float32)
    jx, _ = _x(cfg, 17, torch.float32, seed=4)
    _, jstate = JFORWARD[kind](jp, cfg, jx)
    leaves = [torch.from_numpy(np.array(t)) for t in _leaves(jstate)]
    state = ({"conv": leaves[0], "h": leaves[1]} if kind == "rglru"
             else tuple(leaves))
    steps = np.random.default_rng(5).standard_normal((4, 2, 1, cfg.d_model)).astype(np.float32)
    with torch.inference_mode():
        for xt in steps:
            want, jstate = JDECODE[kind](jp, cfg, jnp.asarray(xt), jstate)
            got, state = DECODE[kind](tp, cfg, torch.from_numpy(xt), state)
            assert got.shape == (2, 1, cfg.d_model)
            assert _rel(got, want) <= TOL[torch.float32]
            for g, w in zip(_leaves(state), _leaves(jstate), strict=True):
                assert _rel(g, w) <= TOL[torch.float32]


def test_rglru_forward_from_a_carried_state():
    """RG-LRU's forward takes a conv history and an ``h`` added at step 0
    (the reference's ``state=``)."""
    cfg, p = _block("rglru", seed=2)
    jp, tp = _sides(p, torch.float32)
    rng = np.random.default_rng(6)
    conv = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    h = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    jx, tx = _x(cfg, 33, torch.float32, seed=7)
    want, wstate = jssm.rglru_forward(jp, cfg, jx, state={"conv": jnp.asarray(conv),
                                                          "h": jnp.asarray(h)})
    got, state = ssm.rglru_forward(tp, cfg, tx, state={"conv": torch.from_numpy(conv),
                                                       "h": torch.from_numpy(h)})
    assert _rel(got, want) <= TOL[torch.float32]
    for name in ("conv", "h"):
        assert _rel(state[name], wstate[name]) <= TOL[torch.float32]


def _decoded_state(fn_decode, p, cfg, x, state, to_step):
    for t in range(x.shape[1]):
        _, state = fn_decode(p, cfg, to_step(x[:, t:t + 1]), state)
    return state


@pytest.mark.parametrize("S,ratio", [(256, 1.0), (300, 3.36e-5), (1819, 1.47e-5)])
def test_mlstm_pad_decay_on_both_sides(S, ratio):
    """The reference's ``mlstm_forward`` pads S up to a multiple of its
    256-step chunk and returns the state after the pad steps; a zero input
    still decays C by σ(f_bias) a step.  At S = 256 (no pad) the prefill's
    C equals that of S decode steps (its norm over theirs is 1); at S = 300
    (212 pad steps) it is 3.36e-5 of it, at S = 1819 (the served prompt, 229
    pad steps) 1.47e-5 (d_model 64, 4 heads, f_bias 3), and the port
    returns the same fraction."""
    cfg, p = _block("mlstm", seed=3)
    p["f_bias"] = np.full_like(p["f_bias"], 3.0)     # the init's bias
    jp, tp = _sides(p, torch.float32)
    jx, tx = _x(cfg, S, torch.float32, seed=8)
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    zeros = (np.zeros((2, H, dh, dh), np.float32), np.zeros((2, H, dh), np.float32))
    _, (jC, _) = jssm.mlstm_forward(jp, cfg, jx)
    jCd, _ = _decoded_state(jssm.mlstm_decode, jp, cfg, jx,
                            tuple(map(jnp.asarray, zeros)), lambda t: t)
    with torch.inference_mode():
        _, (C, _) = ssm.mlstm_forward(tp, cfg, tx)
        Cd, _ = _decoded_state(ssm.mlstm_decode, tp, cfg, tx,
                               tuple(map(torch.from_numpy, zeros)), lambda t: t)
    want = np.linalg.norm(_np(jC)) / np.linalg.norm(_np(jCd))
    got = np.linalg.norm(_np(C)) / np.linalg.norm(_np(Cd))
    assert _rel(Cd, jCd) <= 1e-5
    assert want == pytest.approx(ratio, rel=1e-2)
    assert got == pytest.approx(want, rel=1e-3)


def test_linear_scan_is_the_recurrence():
    """The parallel prefix against the loop h_t = a_t h_{t-1} + b_t in
    float64, at lengths around powers of two."""
    rng = np.random.default_rng(9)
    for S in (1, 2, 3, 7, 8, 9, 64, 300):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S, 5)))
        b = torch.from_numpy(rng.standard_normal((2, S, 5)))
        want, h = torch.empty_like(b), torch.zeros((2, 5), dtype=torch.float64)
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            want[:, t] = h
        np.testing.assert_allclose(ssm.linear_scan(a, b).numpy(), want.numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_float64_inputs_compute_in_float64():
    """The arithmetic type follows float64 inputs (the card's float64
    truth runs the same code), and stays float32 for bfloat16 ones."""
    cfg, p = _block("mlstm")
    tp = {k: torch.from_numpy(v).double() for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 20, 64)))
    y, (C, n) = ssm.mlstm_forward(tp, cfg, x)
    assert y.dtype == C.dtype == n.dtype == torch.float64
    assert ssm._acc(torch.bfloat16) == torch.float32


# ------------------------------------------------------------------ models
def _perturb(tree, rng):
    """Constant leaves (norm scales, biases, ``lam``, ``f_bias``) get noise,
    so those paths are not identities."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_perturb(v, rng) for v in tree)
    a = np.asarray(tree)
    if a.size > 1 and np.all(a == a.flat[0]):
        a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
    return a


def _setup(arch):
    """(reference cfg, port cfg, reference params, port model on the CPU)."""
    jcfg = jget_arch(arch).reduced(**ARCHS[arch])
    cfg = get_arch(arch).reduced(**ARCHS[arch])
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    arrays = _perturb(jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0),
                                                            jnp.float32)),
                      np.random.default_rng(0))
    model = init_lm(cfg, seed=1, dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_arrays(cfg, arrays), strict=True)
    return jcfg, cfg, jax.tree.map(jnp.asarray, arrays), model


def _close(got, want, tol=LOGITS_TOL):
    assert _rel(got, want) <= tol


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape, dtype=np.int32)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_layers_follow_the_pattern_and_remainder(arch):
    _, cfg, _, model = _setup(arch)
    L = len(cfg.pattern)
    n_groups, n_extra = divmod(cfg.n_layers, L)
    assert n_groups >= 1 and n_extra == 2
    assert model.kinds == list(cfg.pattern) * n_groups + list(cfg.pattern[:n_extra])
    full = get_arch(arch)      # the published depth: 2 x 6, and 12 x 3 + 2
    assert divmod(full.n_layers, len(full.pattern)) == \
        {"xlstm-125m": (2, 0), "recurrentgemma-9b": (12, 2)}[arch]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_params_round_trip(arch):
    jcfg, cfg, jparams, model = _setup(arch)
    state = model.state_dict()
    want = jax.tree.map(np.asarray, jparams)
    assert set(state) == set(lm_params_from_arrays(cfg, want))
    back = lm_params_to_arrays(cfg, state)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the recurrent leaves, and lam in float32 in a bfloat16 model
    names = {k.split(".")[-1] for k in state}
    kinds = set(cfg.pattern)
    if "rglru" in kinds:
        assert {"in_x", "in_gate", "conv", "wa", "wi", "lam", "out"} <= names
        lam = init_lm(cfg, dtype=torch.bfloat16, device="cpu").layers[0]["core"]["lam"]
        assert lam.dtype == torch.float32
    else:
        assert {"wi", "wf", "f_bias", "wx", "rh", "bias", "out"} <= names


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_reference(arch):
    jcfg, cfg, jparams, model = _setup(arch)
    tokens = _tokens(cfg, (2, 37), 1)
    want, (jgroups, jextra) = jforward(jparams, jcfg, jnp.asarray(tokens),
                                       use_kernel=True, return_cache=True)
    with torch.inference_mode():
        got, (groups, extra) = model(torch.from_numpy(tokens), return_cache=True)
        plain = model(torch.from_numpy(tokens), use_kernel=False)
    assert got.shape == (2, 37, cfg.vocab)
    _close(got, want)
    _close(plain, want)
    assert len(groups) == len(jgroups) and len(extra) == len(jextra)
    for mine, ref in zip(groups + extra, tuple(jgroups) + tuple(jextra)):
        assert set(mine) == set(ref)
        for name in mine:
            assert tuple(mine[name].shape) == ref[name].shape
            _close(mine[name], ref[name], tol=1e-4)


def test_xlstm_forward_across_the_mlstm_chunk():
    """S = 300: every mLSTM layer pads to 512 and carries its state across
    two chunks."""
    jcfg, cfg, jparams, model = _setup("xlstm-125m")
    tokens = _tokens(cfg, (1, 300), 2)
    want = jforward(jparams, jcfg, jnp.asarray(tokens))
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens))
    _close(got, want)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bfloat16_forward_matches_reference(arch):
    jcfg, cfg, jparams, _ = _setup(arch)
    # lam stays float32 on both sides, as both inits keep it
    jp16 = _keep_lam(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams), jparams)
    model = init_lm(cfg, seed=1, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams)),
                          strict=True)
    tokens = _tokens(cfg, (2, 37), 3)
    want = jforward(jp16, jcfg, jnp.asarray(tokens))
    own = _rel(want, jforward(jparams, jcfg, jnp.asarray(tokens)))
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens), use_kernel=False)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= max(BF16_TOL, own), (_rel(got, want), own)


def _keep_lam(tree16, tree32):
    if isinstance(tree16, dict):
        return {k: (tree32[k] if k == "lam" else _keep_lam(v, tree32[k]))
                for k, v in tree16.items()}
    if isinstance(tree16, tuple):
        return tuple(_keep_lam(a, b) for a, b in zip(tree16, tree32))
    return tree16


@pytest.mark.parametrize("ctx_len", [64, 20])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_to_decode_cache_is_bit_equal(arch, ctx_len):
    """The reference's prefill caches through both conversions: recurrent
    states pass through, attention entries become rings (recurrentgemma's
    reduced window of 32 and a ctx_len of 20 below the prompt)."""
    jcfg, cfg, jparams, _ = _setup(arch)
    tokens = _tokens(cfg, (3, 29), 4)
    _, jcaches = jforward(jparams, jcfg, jnp.asarray(tokens), return_cache=True)
    want = jprefill_to_decode(jcfg, jcaches, ctx_len, 29)
    caches = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jcaches)
    got = prefill_to_decode_cache(cfg, caches, ctx_len, 29)
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), got))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_cache_has_the_reference_layout(arch):
    jcfg, cfg, _, _ = _setup(arch)
    want = jinit_cache(jcfg, 3, 40, dtype=jnp.float32)
    got = init_cache(cfg, 3, 40, dtype=torch.float32, device="cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), got))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_then_decode_matches_reference(arch):
    """Prefill 21 tokens, then 4 decode steps from the converted caches (a
    ring of 32 slots for recurrentgemma's attention, which its 25 tokens
    do not fill; the recurrent states carried); and 4 steps from an empty
    ``init_cache``."""
    jcfg, cfg, jparams, model = _setup(arch)
    S, ctx = 21, 40
    tokens = _tokens(cfg, (2, S), 5)
    steps = _tokens(cfg, (4, 2, 1), 6)
    jlogits, jc = jforward(jparams, jcfg, jnp.asarray(tokens), use_kernel=True,
                           return_cache=True)
    jcache = jprefill_to_decode(jcfg, jc, ctx, S)
    jempty = jinit_cache(jcfg, 2, ctx, dtype=jnp.float32)
    with torch.inference_mode():
        logits, c = model(torch.from_numpy(tokens), return_cache=True)
        cache = prefill_to_decode_cache(cfg, c, ctx, S)
        empty = init_cache(cfg, 2, ctx, dtype=torch.float32, device="cpu")
        _close(logits[:, -1], jlogits[:, -1])
        for t in range(4):
            jl, jcache = jdecode_step(jparams, jcfg, jnp.asarray(steps[t]), jcache,
                                      jnp.int32(S + t))
            lg, cache = model.decode_step(torch.from_numpy(steps[t]), cache, S + t)
            assert lg.shape == (2, cfg.vocab)
            _close(lg, jl)
            jl, jempty = jdecode_step(jparams, jcfg, jnp.asarray(steps[t]), jempty,
                                      jnp.int32(t))
            lg, empty = model.decode_step(torch.from_numpy(steps[t]), empty, t)
            _close(lg, jl)
    for mine, ref in zip(jax.tree.leaves(cache), jax.tree.leaves(jcache)):
        if mine.dtype == torch.int32:
            assert np.array_equal(mine.numpy(), np.asarray(ref))
        else:
            _close(mine, ref)


def _requests(cls, cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=rid, prompt=rng.integers(0, cfg.vocab, n, dtype=np.int32),
                max_new_tokens=5)
            for rid, n in enumerate(lengths)]


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return engine.run()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_engine_greedy_tokens_match_reference(arch):
    """5 requests of mixed lengths in batches of 3 + 2, left-padded with
    token 0; recurrentgemma's ctx_len of 48 is above its window of 32."""
    jcfg, cfg, jparams, model = _setup(arch)
    lengths = [10, 4, 13, 7, 9]
    want = _run(JEngine(jcfg, jparams, max_batch=3, ctx_len=48),
                _requests(JRequest, jcfg, lengths, 0))
    eng = Engine(cfg, model, max_batch=3, ctx_len=48, device="cpu")
    got = _run(eng, _requests(Request, cfg, lengths, 0))
    assert sorted(got) == list(range(5)) and eng.stats["batches"] == 2
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_launcher_on_the_cpu(arch, capsys):
    out = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "2", "--batch", "2", "--prompt-len", "9",
                       "--new-tokens", "3"])
    assert sorted(out) == [0, 1] and all(v.shape == (3,) for v in out.values())
    assert "[serve] 2 requests" in capsys.readouterr().out


def test_recurrent_lms_build_on_the_card_by_default(monkeypatch):
    """Both archs' ``init_lm`` and ``init_cache`` default to the card and
    refuse a machine without one; on the CPU only when asked."""
    for arch in ARCHS:
        cfg = get_arch(arch).reduced(**ARCHS[arch])
        assert isinstance(init_lm(cfg, dtype=torch.float32, device="cpu"), LM)
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: False)
            with pytest.raises(RuntimeError, match="device='cpu'"):
                init_lm(cfg)
            with pytest.raises(RuntimeError, match="device='cpu'"):
                init_cache(cfg, 1, 8)


# --------------------------------------------------------- flash at D 256
# (B, Hq, Hkv, Sq, Skv, D, window): recurrentgemma-9b's MQA (16:1) at head
# dim 256, causal, a window shorter than S, decode alignment (Sq < Skv)
FLASH_CASES = [
    (1, 16, 1, 70, 70, 256, None),
    (2, 4, 1, 77, 77, 256, 16),
    (1, 4, 1, 8, 96, 256, None),
    (1, 4, 1, 19, 83, 256, 24),
]
FLASH_TOL = 2e-5


def _flash_ids(case):
    B, Hq, Hkv, Sq, Skv, D, w = case
    return f"B{B}-H{Hq}/{Hkv}-S{Sq}/{Skv}-D{D}-w{w}"


@pytest.mark.parametrize("case", FLASH_CASES, ids=_flash_ids)
def test_plain_flash_at_head_dim_256_matches_pallas(case):
    """``ops.attention`` (time-major, what the models call) and the
    ``[B, H, S, D]`` wrapper on CPU tensors (the plain version) against the
    reference's Pallas kernel in interpret mode, 32-row blocks."""
    B, Hq, Hkv, Sq, Skv, D, window = case
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    want = np.asarray(jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=True, window=window, use_kernel=True,
                                     block_q=32, block_k=32, interpret=True))
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=FLASH_TOL, atol=FLASH_TOL)
    qt, kt, vt = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    wantt = np.asarray(jflash(jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt),
                              causal=True, window=window, block_q=32, block_k=32,
                              interpret=True))
    before = fa.flash_attention.launches
    gott = fa.flash_attention(torch.from_numpy(qt), torch.from_numpy(kt),
                              torch.from_numpy(vt), causal=True, window=window)
    assert fa.flash_attention.launches == before
    np.testing.assert_allclose(gott.numpy(), wantt, rtol=FLASH_TOL, atol=FLASH_TOL)
    assert 256 in fa.HEAD_DIMS
