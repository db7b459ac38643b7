"""The port's attention paths for training and decode against the
reference, on the CPU, float32:

- ``chunked_attention`` (the online softmax over key chunks, each chunk
  step under ``torch.utils.checkpoint``) and its gradient with respect to
  q, k and v against the reference's and ``jax.grad``, at S > chunk (keys
  padded to a whole chunk), GQA, with and without a window: values at
  1e-5 (two summation orders of float32 chunk sums), gradients at 1e-4 of
  their max (a backward through the online softmax sums every chunk's
  terms again in another order);
- ``attn_forward``'s three-way dispatch (kernel / chunked past ``chunk`` /
  plain) against the reference's ``attn_forward`` at 1e-5;
- ``attn_decode`` (the static-cache decode) against the reference's at
  1e-5, with and without a window;
- the refusal: ``ops.attention(use_kernel=True)`` raises with grad mode on
  and an operand that requires grad (the reference's kernel has no VJP:
  ``jax.grad`` through it fails), and serves under ``no_grad``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models.attention import attn_decode as jattn_decode  # noqa: E402
from repro.models.attention import attn_forward as jattn_forward  # noqa: E402
from repro.models.attention import chunked_attention as jchunked  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.models.attention import (attn_decode, attn_forward,  # noqa: E402
                                          chunked_attention)
from repro_torch.models.model import init_lm  # noqa: E402

VAL_TOL = 1e-5
GRAD_TOL = 1e-4


def _qkv(B, S, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("window", [None, 7, 40])
@pytest.mark.parametrize("S,chunk", [(40, 16), (64, 16), (37, 64)])
def test_chunked_attention_and_grad_match_reference(S, chunk, window):
    q, k, v = _qkv(2, S, 4, 2, 8, seed=S)
    w = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        out = jchunked(q, k, v, causal=True, window=window, chunk=chunk)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = chunked_attention(tq, tk, tv, causal=True, window=window,
                            chunk=chunk)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.shape == q.shape and out.dtype == torch.float32
    assert _rel(out.detach().numpy(), jout) <= VAL_TOL
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert _rel(got.numpy(), want) <= GRAD_TOL


def test_chunked_attention_checkpoints_each_chunk_step():
    """Under grad mode every chunk step is a ``torch.utils.checkpoint``
    region (its scores are recomputed in the backward, not kept); without
    grad the steps run directly; both give the same values."""
    import torch.utils.checkpoint as ckpt

    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 50, 2, 1, 8))
    calls = []
    orig = ckpt.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn.__name__)
        return orig(fn, *args, **kw)

    import repro_torch.models.attention as att
    try:
        att.checkpoint = counting
        with torch.no_grad():
            a = chunked_attention(q, k, v, chunk=16)
        assert calls == []
        b = chunked_attention(q.requires_grad_(), k, v, chunk=16)
        assert calls == ["_chunk_step"] * 4        # 50 keys: 4 chunks of 16
    finally:
        att.checkpoint = orig
    assert torch.equal(a, b.detach())


def _attn_setup(arch, window=None, **kw):
    jcfg = jget_arch(arch).reduced(**kw)
    cfg = get_arch(arch).reduced(**kw)
    if window is not None:
        jcfg = dataclasses.replace(jcfg, window=window)
        cfg = dataclasses.replace(cfg, window=window)
    arrays = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(3),
                                                   jnp.float32))
    model = init_lm(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(lm_params_from_arrays(cfg, arrays))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), arrays["groups"][0]["core"])
    return jcfg, cfg, jp, model.layers[0]["core"]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("S", [12, 45])
def test_attn_forward_dispatch_matches_reference(S, use_kernel):
    """chunk 16: S = 45 runs ``chunked_attention`` on the plain side of
    both packages, S = 12 the plain version; with ``use_kernel`` the port's
    wrapper takes the plain version on the CPU, the reference's the Pallas
    kernel in interpret mode."""
    jcfg, cfg, jp, p = _attn_setup("qwen3-1.7b", n_layers=1, d_model=64,
                                   n_heads=4)
    x = np.random.default_rng(S).standard_normal((2, S, 64)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want, (jk, jv) = jattn_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                   use_kernel=use_kernel, chunk=16)
    with torch.no_grad():
        got, (k, v) = attn_forward(p, cfg, torch.from_numpy(x),
                                   torch.from_numpy(pos),
                                   use_kernel=use_kernel, chunk=16)
    assert _rel(got.numpy(), want) <= VAL_TOL
    assert _rel(k.numpy(), jk) <= VAL_TOL and _rel(v.numpy(), jv) <= VAL_TOL


@pytest.mark.parametrize("window", [None, 5])
def test_attn_decode_matches_reference(window):
    jcfg, cfg, jp, p = _attn_setup("qwen2-0.5b", window=window, n_layers=1,
                                   d_model=32, n_heads=4)
    rng = np.random.default_rng(4)
    S_max = 12
    ck = rng.standard_normal((2, S_max, cfg.n_kv_heads, cfg.head_dim)) \
        .astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    jck, jcv = jnp.asarray(ck), jnp.asarray(cv)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    first = tck
    for pos in (0, 3, 9):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jck, jcv = jattn_decode(jp, jcfg, jnp.asarray(x), jck, jcv,
                                      jnp.int32(pos))
        with torch.no_grad():
            got, tck, tcv = attn_decode(p, cfg, torch.from_numpy(x), tck, tcv,
                                        pos)
        assert _rel(got.numpy(), want) <= VAL_TOL
        assert _rel(tck.numpy(), jck) <= VAL_TOL
        assert _rel(tcv.numpy(), jcv) <= VAL_TOL
    assert np.array_equal(first.numpy(), ck)      # functional: no update in place


@pytest.mark.parametrize("grad_on", ["q", "k", "v"])
def test_flash_attention_refuses_grad_mode(grad_on):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 2, 1, 8))
    args = {"q": q, "k": k, "v": v}
    args[grad_on] = args[grad_on].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.attention(args["q"], args["k"], args["v"], use_kernel=True)
    with torch.no_grad():
        out = ops.attention(args["q"], args["k"], args["v"], use_kernel=True)
    assert out.shape == q.shape and not out.requires_grad
    # the plain version differentiates
    ops.attention(args["q"], args["k"], args["v"], use_kernel=False).sum() \
        .backward()
    assert args[grad_on].grad is not None
