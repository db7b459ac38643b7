"""The embedding-input archs (``embed_input=False``: a stub frontend feeds
``[B, S, d]`` embeddings; no ``embed``, an untied ``lm_head``) on the CPU
against the reference: phi-3-vision-4.2b at head dim 96 (the width of its
32 heads of 3072 / 32, cut to 2 heads of 96) and musicgen-medium (layernorm,
plain gelu MLP), the same parameters carried over by
``lm_params_from_arrays`` (norm scales and biases perturbed so those paths
act):

- the parameter trees: no ``embed``, an ``lm_head``, round trip bit-equal;
- prefill logits and caches against the reference's
  ``forward(use_kernel=True)`` (Pallas in interpret mode) at rtol/atol 1e-4
  (two BLAS libraries summing in other orders), the plain path too;
- prefill + 4 ``decode_step`` s fed zero embeddings, at 1e-4;
- the engine's greedy tokens equal to the reference engine's for
  right-aligned embedding prompts of mixed lengths (zero rows pad, zero
  embeddings at decode);
- the serve launcher on an embedding arch (``--seed``'s stub embeddings);
- the plain flash path at head dim 96 against the Pallas kernel in
  interpret mode at 2e-5 (the flash tests' bar).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.models.model import decode_step as jdecode_step  # noqa: E402
from repro.models.model import forward as jforward  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import prefill_to_decode_cache as jprefill_to_decode  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_arrays, lm_params_to_arrays  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import init_cache, init_lm  # noqa: E402
from repro_torch.serve import Engine, Request, prefill_to_decode_cache  # noqa: E402

TOL = 1e-4
ARCHS = {
    "phi-3-vision-4.2b": dict(n_layers=2, d_model=192, n_heads=2, vocab=128),
    "musicgen-medium": dict(n_layers=2, d_model=64, n_heads=4, vocab=128),
}


def _perturb(tree, rng):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_perturb(v, rng) for v in tree)
    a = np.asarray(tree)
    if np.all(a == 0.0) or np.all(a == 1.0):
        a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
    return a


def _setup(arch):
    jcfg = jget_arch(arch).reduced(**ARCHS[arch])
    cfg = get_arch(arch).reduced(**ARCHS[arch])
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert not cfg.embed_input
    arrays = _perturb(jax.tree.map(np.asarray, jinit_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32)), np.random.default_rng(0))
    model = init_lm(cfg, seed=1, dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_arrays(cfg, arrays), strict=True)
    return jcfg, cfg, jax.tree.map(jnp.asarray, arrays), model


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _embeds(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_params_have_no_embed_and_round_trip(arch):
    jcfg, cfg, jparams, model = _setup(arch)
    assert "embed" not in jparams and "lm_head" in jparams
    assert model.embed is None and model.lm_head is not None
    assert cfg.head_dim == (96 if arch.startswith("phi") else 16)
    back = lm_params_to_arrays(cfg, model.state_dict())
    want = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    groups, extra = init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    assert groups[0]["k"].shape == (2, 2, 8, cfg.n_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_then_decode_matches_reference(arch):
    jcfg, cfg, jparams, model = _setup(arch)
    S, ctx = 21, 32
    x = _embeds(cfg, (2, S), 1)
    jlogits, jc = jforward(jparams, jcfg, jnp.asarray(x), use_kernel=True,
                           return_cache=True)
    jcache = jprefill_to_decode(jcfg, jc, ctx, S)
    zero = np.zeros((2, 1, cfg.d_model), np.float32)
    with torch.inference_mode():
        logits, c = model(torch.from_numpy(x), return_cache=True)
        plain = model(torch.from_numpy(x), use_kernel=False)
        assert logits.shape == (2, S, cfg.vocab)
        _close(logits, jlogits)
        _close(plain, jlogits)
        ((gc,), _), ((jgc,), _) = c, jc
        _close(gc["k"], jgc["k"])
        _close(gc["v"], jgc["v"])
        cache = prefill_to_decode_cache(cfg, c, ctx, S)
        for t in range(4):
            jl, jcache = jdecode_step(jparams, jcfg, jnp.asarray(zero), jcache,
                                      jnp.int32(S + t))
            lg, cache = model.decode_step(torch.from_numpy(zero), cache, S + t)
            assert lg.shape == (2, cfg.vocab)
            _close(lg, jl)


def _requests(cls, cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=rid, prompt=rng.standard_normal((n, cfg.d_model))
                .astype(np.float32), max_new_tokens=5)
            for rid, n in enumerate(lengths)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_engine_greedy_tokens_match_reference(arch):
    """5 embedding prompts of mixed lengths in batches of 3 + 2: right-
    aligned over zero rows, decoded on zero embeddings, as the reference's
    engine does."""
    jcfg, cfg, jparams, model = _setup(arch)
    lengths = [10, 4, 13, 7, 2]
    want = {}
    jeng = JEngine(jcfg, jparams, max_batch=3, ctx_len=32)
    for r in _requests(JRequest, jcfg, lengths, 0):
        jeng.submit(r)
    want = jeng.run()
    eng = Engine(cfg, model, max_batch=3, ctx_len=32, device="cpu")
    for r in _requests(Request, cfg, lengths, 0):
        eng.submit(r)
    got = eng.run()
    assert sorted(got) == list(range(5)) and eng.stats["batches"] == 2
    for rid in want:
        assert got[rid].shape == (5,)
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))


def test_serve_launcher_serves_an_embedding_arch(capsys):
    out = tserve.main(["--arch", "musicgen-medium", "--reduced", "--device",
                       "cpu", "--requests", "3", "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "3", "--seed", "5"])
    assert sorted(out) == [0, 1, 2] and all(v.shape == (3,) for v in out.values())
    assert "[serve] 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("window", [None, 24])
def test_plain_flash_at_head_dim_96_matches_pallas(window):
    """The time-major ``ops.attention`` (the plain version on the CPU) at
    phi-3-vision's head dim against the Pallas kernel in interpret mode, 2e-5
    of max|out|."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 70, h, 96)).astype(np.float32)
               for h in (4, 2, 2))
    want = np.asarray(jops.attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True, window=window,
                                     use_kernel=True, block_q=32, block_k=32))
    with torch.no_grad():
        got = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=True, window=window).numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
