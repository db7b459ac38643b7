"""The LM (port of ``repro/models/model.py``) for dense, attention-only
architectures: ``cfg.pattern == ("attn",)``, no MoE, token inputs.

The reference stacks identical layer groups and drives them with
``lax.scan``; here every layer is a module of a :class:`~torch.nn.ModuleList`
walked in Python.  A layer's parameters keep the reference's tree
(``ln1``, ``core`` with ``wq``/``wk``/``wv``/``wo`` and optional
``bq``/``bk``/``bv``/``q_norm``/``k_norm``, ``ln2``, ``ffn``), so a state-dict
key is the reference's path with the group axis unstacked:
``layers.<i>.core.wq`` ↔ ``groups[0]["core"]["wq"][i]`` (see
:mod:`repro_torch.convert`).

Caches keep the reference's layout too: ``forward(return_cache=True)``
returns ``(({"k", "v"},), ())`` with ``[n_layers, B, S, Hkv, Dh]`` tensors,
and the decode cache of :func:`init_cache` /
:func:`repro_torch.serve.engine.prefill_to_decode_cache` is
``(({"k", "v", "slot_pos"},), ())``.  Unlike the reference,
:meth:`LM.decode_step` updates the decode cache in place (one ring-buffer
slot per layer) instead of returning a copy.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .attention import _project_qkv, attn_forward, attn_params
from .layers import apply_rope, make_norm, mlp, mlp_params, norm_params, normal_init

NEG_INF = -1e30


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks (models/moe.py) are not ported yet "
            f"(ROADMAP queue 1 item 13)")
    if tuple(cfg.pattern) != ("attn",):
        raise NotImplementedError(
            f"{cfg.name}: block kinds {cfg.pattern} (models/ssm.py) are not "
            f"ported yet; only ('attn',) is (ROADMAP queue 1 item 13)")
    if not cfg.embed_input:
        raise NotImplementedError(
            f"{cfg.name}: embed_input=False archs (a stub frontend feeding "
            f"embeddings) are not ported yet (ROADMAP queue 1 item 13)")


class ParamTree(nn.Module):
    """A nested parameter dict as a module: tensors become (frozen)
    parameters, dicts become submodules, and ``p[name]`` reads either, so
    the layer functions index it as they index the reference's pytree."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def block_params(gen, cfg, dtype, device) -> dict:
    p = {"ln1": norm_params(cfg.norm, cfg.d_model, dtype, device),
         "core": attn_params(gen, cfg, dtype, device)}
    if cfg.d_ff > 0:
        p["ln2"] = norm_params(cfg.norm, cfg.d_model, dtype, device)
        p["ffn"] = mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype, device)
    return p


def block_forward(p, cfg, x, positions, use_kernel: bool = True):
    """Full-sequence block.  Returns (x, (k, v))."""
    norm = make_norm(cfg.norm)
    out, kv = attn_forward(p["core"], cfg, norm(p["ln1"], x), positions,
                           use_kernel=use_kernel)
    x = x + out
    if cfg.d_ff > 0:
        x = x + mlp(p["ffn"], norm(p["ln2"], x), cfg.act)
    return x, kv


def attn_decode_cached(p, cfg, x, cache: dict, pos: int):
    """Ring-buffer decode of one token for one layer: cache slots carry
    absolute positions (``slot_pos``, -1 = empty).  ``cache`` holds this
    layer's ``k``/``v`` ``[B, clen, Hkv, Dh]`` and ``slot_pos`` ``[clen]``;
    slot ``pos % clen`` is overwritten in place.  Plain torch ops, as the
    reference uses plain einsums here."""
    b = x.shape[0]
    cache_k, cache_v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    clen = cache_k.shape[1]
    q, k, v = _project_qkv(p, cfg, x)
    posn = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posn, cfg.rope_theta)
    k = apply_rope(k, posn, cfg.rope_theta)
    slot = pos % clen
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    slot_pos[slot] = pos
    group = cfg.n_heads // cfg.n_kv_heads
    q5 = q.reshape(b, 1, cfg.n_kv_heads, group, cfg.head_dim)
    # float32 scores (the reference's preferred_element_type)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), cache_k.float()) \
        * cfg.head_dim ** -0.5
    mask = (slot_pos <= pos) & (slot_pos >= 0)
    if cfg.window is not None:
        mask &= slot_pos > pos - cfg.window
    s = torch.where(mask, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", pr.to(cache_v.dtype), cache_v)
    out = out.to(x.dtype).reshape(b, 1, -1)
    return out @ p["wo"]


def block_decode(p, cfg, x, cache: dict, pos: int):
    norm = make_norm(cfg.norm)
    x = x + attn_decode_cached(p["core"], cfg, norm(p["ln1"], x), cache, pos)
    if cfg.d_ff > 0:
        x = x + mlp(p["ffn"], norm(p["ln2"], x), cfg.act)
    return x


def init_params(cfg, gen: torch.Generator, dtype, device) -> dict:
    """Random parameters at the reference's scales (normal × fan_in^-0.5 for
    projections, 0.02 for embed and head, ones/zeros for norms and biases):
    ``{"embed", "layers": [block...], "final_norm"[, "lm_head"]}``."""
    check_supported(cfg)
    params = {"embed": normal_init(gen, (cfg.vocab, cfg.d_model), 0.02, dtype,
                                   device),
              "layers": [block_params(gen, cfg, dtype, device)
                         for _ in range(cfg.n_layers)],
              "final_norm": norm_params(cfg.norm, cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (cfg.d_model, cfg.vocab), 0.02,
                                        dtype, device)
    return params


class LM(nn.Module):
    """Decoder-only LM: embed → layers → final norm → unembed (tied:
    ``x @ embed.T``)."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.layers = nn.ModuleList(ParamTree(p) for p in params["layers"])
        self.final_norm = ParamTree(params["final_norm"])
        self.lm_head = (nn.Parameter(params["lm_head"], requires_grad=False)
                        if "lm_head" in params else None)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def embed_inputs(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens]

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return x @ self.embed.T
        return x @ self.lm_head

    def forward(self, tokens: torch.Tensor, return_cache: bool = False,
                use_kernel: bool = True):
        """Prefill forward.  tokens: [B, S] → logits [B, S, V] (and the
        per-layer caches when ``return_cache``).  ``use_kernel=False`` runs
        the plain attention instead of the flash-attention kernel."""
        cfg = self.cfg
        x = self.embed_inputs(tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        ks, vs = [], []
        for layer in self.layers:
            x, (k, v) = block_forward(layer, cfg, x, positions, use_kernel)
            if return_cache:
                ks.append(k)
                vs.append(v)
        x = make_norm(cfg.norm)(self.final_norm, x)
        logits = self.unembed(x)
        if return_cache:
            return logits, (({"k": torch.stack(ks), "v": torch.stack(vs)},), ())
        return logits

    def decode_step(self, tokens: torch.Tensor, cache, pos: int):
        """One-token decode.  tokens: [B, 1]; ``cache`` from
        :func:`init_cache` or ``prefill_to_decode_cache`` (updated in place);
        ``pos``: tokens so far.  Returns (logits [B, V], cache)."""
        cfg = self.cfg
        (gc,), _ = cache
        x = self.embed_inputs(tokens)
        for i, layer in enumerate(self.layers):
            layer_cache = {"k": gc["k"][i], "v": gc["v"][i],
                           "slot_pos": gc["slot_pos"][i]}
            x = block_decode(layer, cfg, x, layer_cache, pos)
        x = make_norm(cfg.norm)(self.final_norm, x)
        return self.unembed(x)[:, 0], cache


def init_lm(cfg, seed: int = 0, dtype=torch.bfloat16, device="cuda") -> LM:
    """A randomly initialised :class:`LM` on ``device`` (the card unless
    ``device="cpu"``), drawn from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, init_params(cfg, gen, dtype, dev))


def init_cache(cfg, batch: int, ctx_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """Empty decode caches ``(({"k", "v", "slot_pos"},), ())``: k/v
    ``[n_layers, batch, clen, Hkv, Dh]``, slot_pos ``[n_layers, clen]`` = -1,
    clen = ``min(ctx_len, window)``."""
    check_supported(cfg)
    dev = resolve_device(device)
    clen = min(ctx_len, cfg.window) if cfg.window else ctx_len
    shape = (cfg.n_layers, batch, clen, cfg.n_kv_heads, cfg.head_dim)
    return ({"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev),
             "slot_pos": torch.full((cfg.n_layers, clen), -1,
                                    dtype=torch.int32, device=dev)},), ()
