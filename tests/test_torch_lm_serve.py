"""The port's LM serving path on the CPU against the reference, on reduced
``qwen3-1.7b`` (qk-norm, tied embeddings, GQA), ``qwen2-0.5b`` (qkv bias,
GQA) and ``starcoder2-7b`` (layernorm, plain gelu MLP, untied head): the
same parameters (the reference's init, carried over by
``lm_params_from_arrays``, with norm scales and biases perturbed so those
paths are not identities) go through both.

- prefill logits and caches against the reference's
  ``forward(use_kernel=True)`` (Pallas in interpret mode) at rtol/atol 1e-4:
  two BLAS libraries summing in other orders;
- the same forward in bfloat16 (plain attention) against the reference's
  bfloat16 ``forward`` at 3e-2 of max|logits| (``BF16_TOL``);
- ``prefill_to_decode_cache``: pure data movement, bit for bit;
- prefill + 4 ``decode_step``s at 1e-4;
- ``Engine.run`` greedy tokens equal to the reference engine's, and in a
  mixed-temperature batch the greedy rows equal and the sampled rows valid.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models.model import decode_step as jdecode_step  # noqa: E402
from repro.models.model import forward as jforward  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import prefill_to_decode_cache as jprefill_to_decode  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_arrays, lm_params_to_arrays  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import LM, init_lm  # noqa: E402
from repro_torch.serve import Engine, Request, prefill_to_decode_cache  # noqa: E402

TOL = 1e-4
ARCHS = {
    "qwen3-1.7b": dict(n_layers=2, d_model=64, n_heads=4, vocab=256),
    "qwen2-0.5b": dict(n_layers=2, d_model=32, n_heads=4, vocab=128),
    "starcoder2-7b": dict(n_layers=2, d_model=64, n_heads=4, vocab=256),
}


def _perturb(tree, rng):
    """Norm scales (ones) and biases (zeros) get noise, so qk-norm, the final
    norm and the qkv bias really act."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_perturb(v, rng) for v in tree)
    a = np.asarray(tree)
    if np.all(a == 0.0) or np.all(a == 1.0):
        a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
    return a


def _setup(arch, window=None):
    """(reference cfg, port cfg, reference params, port model on the CPU)."""
    jcfg = jget_arch(arch).reduced(**ARCHS[arch])
    cfg = get_arch(arch).reduced(**ARCHS[arch])
    if window is not None:
        jcfg = dataclasses.replace(jcfg, window=window)
        cfg = dataclasses.replace(cfg, window=window)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    arrays = _perturb(jax.tree.map(np.asarray,
                                   jinit_params(jcfg, jax.random.PRNGKey(0),
                                                jnp.float32)),
                      np.random.default_rng(0))
    model = init_lm(cfg, seed=1, dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_arrays(cfg, arrays), strict=True)
    return jcfg, cfg, jax.tree.map(jnp.asarray, arrays), model


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_params_round_trip(arch):
    jcfg, cfg, jparams, model = _setup(arch)
    state = model.state_dict()
    assert set(state) == set(lm_params_from_arrays(
        cfg, jax.tree.map(np.asarray, jparams)))
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
        got, ((caches,), extra) = model(torch.from_numpy(tokens),
                                        return_cache=True)
        plain = model(torch.from_numpy(tokens), use_kernel=False)
    assert got.shape == (2, 37, cfg.vocab) and extra == ()
    _close(got, want)
    _close(plain, want)
    for name in ("k", "v"):
        assert caches[name].shape == jcaches[0][name].shape
        _close(caches[name], jcaches[0][name])


# bfloat16 logits, error over max|logits|: both sides hold the same bfloat16
# weights and round activations to bfloat16 (8-bit mantissa: an ulp of the
# largest logit is 4e-3 to 6e-3 of it here), but at different places; either
# side's bfloat16 logits sit 1e-2 to 2.5e-2 of max|logits| from its own
# float32 ones at these sizes, so 3e-2 (some five ulps) bounds two such
# rounding paths that disagree, and a wrong layer shows as O(1)
BF16_TOL = 3e-2


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bfloat16_forward_matches_reference(arch):
    """The port in bfloat16 (plain attention) against the reference's
    ``forward`` in bfloat16, on the same carried-over weights rounded to
    bfloat16 on each side (bit-equal: both round to nearest even)."""
    jcfg, cfg, jparams, _ = _setup(arch)
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    model = init_lm(cfg, seed=1, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams)),
                          strict=True)
    back = lm_params_to_arrays(cfg, {k: t.float() for k, t in model.state_dict().items()})
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp16)):
        assert np.array_equal(a, np.asarray(b.astype(jnp.float32)))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 37), dtype=np.int32)
    want = np.asarray(jforward(jp16, jcfg, jnp.asarray(tokens)).astype(jnp.float32))
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens), use_kernel=False)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 37, cfg.vocab)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), err


@pytest.mark.parametrize("ctx_len,window", [(64, None), (20, None), (64, 16)])
def test_prefill_to_decode_cache_is_bit_equal(ctx_len, window):
    """The same prefill caches (the reference's, as numpy) through both
    conversions: a cache longer than the prompt, a ring that wraps, and a
    sliding-window ring."""
    jcfg, cfg, jparams, _ = _setup("qwen3-1.7b", window=window)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (3, 29),
                                               dtype=np.int32)
    _, jcaches = jforward(jparams, jcfg, jnp.asarray(tokens),
                          return_cache=True)
    want = jprefill_to_decode(jcfg, jcaches, ctx_len, 29)
    caches = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jcaches)
    got = prefill_to_decode_cache(cfg, caches, ctx_len, 29)
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), got))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("arch,window", [(a, None) for a in sorted(ARCHS)]
                         + [("qwen3-1.7b", 16)])
def test_prefill_then_decode_matches_reference(arch, window):
    """Window 16 < S: windowed prefill attention, and a decode ring of 16
    slots that wraps."""
    jcfg, cfg, jparams, model = _setup(arch, window=window)
    rng = np.random.default_rng(3)
    S, ctx = 21, 32
    tokens = rng.integers(0, cfg.vocab, (2, S), dtype=np.int32)
    steps = rng.integers(0, cfg.vocab, (4, 2, 1), dtype=np.int32)
    jlogits, jc = jforward(jparams, jcfg, jnp.asarray(tokens),
                           use_kernel=True, return_cache=True)
    jcache = jprefill_to_decode(jcfg, jc, ctx, S)
    with torch.inference_mode():
        logits, c = model(torch.from_numpy(tokens), return_cache=True)
        cache = prefill_to_decode_cache(cfg, c, ctx, S)
        _close(logits[:, -1], jlogits[:, -1])
        for t in range(4):
            jl, jcache = jdecode_step(jparams, jcfg, jnp.asarray(steps[t]),
                                      jcache, jnp.int32(S + t))
            lg, cache = model.decode_step(torch.from_numpy(steps[t]), cache,
                                          S + t)
            assert lg.shape == (2, cfg.vocab)
            _close(lg, jl)
        ((gc,), _), ((jgc,), _) = cache, jcache
        _close(gc["k"], jgc["k"])
        assert np.array_equal(gc["slot_pos"].numpy(), np.asarray(jgc["slot_pos"]))


def _requests(cls, cfg, lengths, temps, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=rid, prompt=rng.integers(0, cfg.vocab, n, dtype=np.int32),
                max_new_tokens=5, temperature=t)
            for rid, (n, t) in enumerate(zip(lengths, temps))]


def _run(engine, reqs, **kw):
    for r in reqs:
        engine.submit(r)
    return engine.run(**kw)


def test_engine_greedy_tokens_match_reference():
    """``test_engine_batched_generation``'s shapes, with mixed prompt
    lengths: 7 requests in batches of 3 + 3 + 1, left-padded with token 0."""
    jcfg, cfg, jparams, model = _setup("qwen2-0.5b")
    lengths = [10, 4, 13, 7, 10, 2, 9]
    want = _run(JEngine(jcfg, jparams, max_batch=3, ctx_len=64),
                _requests(JRequest, jcfg, lengths, [0.0] * 7, 0))
    eng = Engine(cfg, model, max_batch=3, ctx_len=64, device="cpu")
    got = _run(eng, _requests(Request, cfg, lengths, [0.0] * 7, 0))
    assert sorted(got) == list(range(7)) and eng.stats["batches"] == 3
    assert eng.stats["tokens"] == 5 * 7
    for rid in want:
        assert got[rid].shape == (5,)
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))


def test_engine_mixed_temperature_batch():
    """A sampled request first, two greedy ones after it in the same batch:
    the greedy rows equal the reference's, the sampled row is valid tokens
    (its bits cannot match JAX's), and a rerun with the same seed repeats."""
    jcfg, cfg, jparams, model = _setup("qwen2-0.5b")
    temps = [1.5, 0.0, 0.0]
    want = _run(JEngine(jcfg, jparams, max_batch=3, ctx_len=64),
                _requests(JRequest, jcfg, [10, 6, 10], temps, 7))
    runs = [_run(Engine(cfg, model, max_batch=3, ctx_len=64, device="cpu"),
                 _requests(Request, cfg, [10, 6, 10], temps, 7), seed=s)
            for s in (0, 0)]
    for rid in (1, 2):
        np.testing.assert_array_equal(runs[0][rid], np.asarray(want[rid]))
    sampled = runs[0][0]
    assert sampled.shape == (5,) and ((sampled >= 0) & (sampled < cfg.vocab)).all()
    for rid in range(3):
        np.testing.assert_array_equal(runs[0][rid], runs[1][rid])


def test_serve_launcher_on_the_cpu(capsys):
    out = tserve.main(["--solver", "lm", "--arch", "qwen3-1.7b", "--reduced",
                       "--device", "cpu", "--requests", "3", "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "3"])
    assert sorted(out) == [0, 1, 2] and all(v.shape == (3,) for v in out.values())
    assert "[serve] 3 requests" in capsys.readouterr().out


def test_lm_refuses_a_model_on_another_device():
    _, cfg, _, model = _setup("qwen3-1.7b")
    assert isinstance(model, LM) and model.device.type == "cpu"
    model.to("meta")
    with pytest.raises(ValueError, match="lies on"):
        Engine(cfg, model, device="cpu")
