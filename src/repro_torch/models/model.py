"""The LM (port of ``repro/models/model.py``): token inputs; layers of the
kinds ``attn`` (GQA attention, prefill through the flash-attention kernel),
``mlstm``, ``slstm`` and ``rglru`` (:mod:`repro_torch.models.ssm`), laid out
as ``cfg.pattern`` repeated and then the ``n_layers % len(pattern)``
remainder blocks; a dense MLP or a Mixture-of-Experts FFN
(:mod:`repro_torch.models.moe`, where ``cfg.is_moe``) after the blocks that
have one (:func:`_has_ffn`).

The reference stacks identical layer groups and drives them with
``lax.scan``; here every layer is a module of a :class:`~torch.nn.ModuleList`
walked in Python.  A layer's parameters keep the reference's tree
(``ln1``, ``core``, ``ln2``, ``ffn``), so a state-dict key is the
reference's path with the group axis unstacked: ``layers.<g L + j>.core.wq``
↔ ``groups[j]["core"]["wq"][g]`` for pattern length L, and the remainder
blocks ``layers.<n_groups L + e>`` ↔ ``extra[e]`` (see
:mod:`repro_torch.convert`).

Caches keep the reference's layout too: ``forward(return_cache=True)``
returns ``(groups, extra)``, ``groups`` one dict per pattern position with
its entries stacked over the groups (``attn``: ``k``/``v`` ``[n_groups, B,
S, Hkv, Dh]``; ``mlstm``: ``C``/``n``; ``slstm``: ``h``/``c``/``n``;
``rglru``: ``conv``/``h``), ``extra`` one unstacked dict per remainder
block; the decode cache of :func:`init_cache` /
:func:`repro_torch.serve.engine.prefill_to_decode_cache` adds ``slot_pos``
to the attention entries.  Unlike the reference, :meth:`LM.decode_step`
updates the decode cache in place (one ring-buffer slot per attention
layer, the new state of a recurrent one) instead of returning a copy.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .attention import _project_qkv, attn_forward, attn_params
from .layers import apply_rope, make_norm, mlp, mlp_params, norm_params, normal_init
from .moe import moe_ffn_tp, moe_params
from .ssm import PARAMS as RECURRENT_PARAMS
from .ssm import recurrent_cache, recurrent_decode, recurrent_forward

NEG_INF = -1e30


KINDS = ("attn", *RECURRENT_PARAMS)


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet
    (``ValueError`` for a block kind the reference does not have either)."""
    unknown = sorted(set(cfg.pattern) - set(KINDS))
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {unknown}; the "
                         f"kinds are {KINDS}")
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


def _has_ffn(cfg, kind: str) -> bool:
    """As the reference: a dense FFN after every block where ``d_ff > 0``,
    an MoE FFN after the attention blocks only."""
    return cfg.d_ff > 0 or (cfg.is_moe and kind == "attn")


def layer_kind(cfg, i: int) -> str:
    """The kind of layer ``i``: ``cfg.pattern`` repeated over the groups,
    then its first ``n_layers % len(pattern)`` kinds as the remainder."""
    return cfg.pattern[i % len(cfg.pattern)]


def block_params(gen, cfg, kind: str, dtype, device) -> dict:
    core = attn_params if kind == "attn" else RECURRENT_PARAMS[kind]
    p = {"ln1": norm_params(cfg.norm, cfg.d_model, dtype, device),
         "core": core(gen, cfg, dtype, device)}
    if _has_ffn(cfg, kind):
        p["ln2"] = norm_params(cfg.norm, cfg.d_model, dtype, device)
        p["ffn"] = (moe_params(gen, cfg, dtype, device) if cfg.is_moe else
                    mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                               device))
    return p


def _ffn_apply(p, cfg, x, moe_stats: dict | None = None):
    if cfg.is_moe:
        return moe_ffn_tp(p["ffn"], cfg, x, moe_stats)
    return mlp(p["ffn"], x, cfg.act)


def block_forward(p, cfg, kind: str, x, positions, use_kernel: bool = True):
    """Full-sequence block.  Returns (x, cache entry): ``{"k", "v"}`` for
    attention, the final state for a recurrent block."""
    norm = make_norm(cfg.norm)
    h = norm(p["ln1"], x)
    if kind == "attn":
        out, (k, v) = attn_forward(p["core"], cfg, h, positions,
                                   use_kernel=use_kernel)
        cache = {"k": k, "v": v}
    else:
        out, cache = recurrent_forward(p["core"], cfg, kind, h)
    x = x + out
    if _has_ffn(cfg, kind):
        x = x + _ffn_apply(p, cfg, norm(p["ln2"], x))
    return x, cache


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


def block_decode(p, cfg, kind: str, x, cache: dict, pos: int,
                 moe_stats: dict | None = None):
    """One token through one block; ``cache`` (this layer's entry, views
    of the stacked caches) is updated in place."""
    norm = make_norm(cfg.norm)
    h = norm(p["ln1"], x)
    if kind == "attn":
        x = x + attn_decode_cached(p["core"], cfg, h, cache, pos)
    else:
        out, new = recurrent_decode(p["core"], cfg, kind, h, cache)
        for name, t in new.items():
            cache[name].copy_(t)
        x = x + out
    if _has_ffn(cfg, kind):
        x = x + _ffn_apply(p, cfg, norm(p["ln2"], x), moe_stats)
    return x


def init_params(cfg, gen: torch.Generator, dtype, device) -> dict:
    """Random parameters at the reference's scales (normal × fan_in^-0.5 for
    projections, 0.02 for embed and head, ones/zeros for norms and biases):
    ``{"embed", "layers": [block...], "final_norm"[, "lm_head"]}``."""
    check_supported(cfg)
    params = {"embed": normal_init(gen, (cfg.vocab, cfg.d_model), 0.02, dtype,
                                   device),
              "layers": [block_params(gen, cfg, layer_kind(cfg, i), dtype, device)
                         for i in range(cfg.n_layers)],
              "final_norm": norm_params(cfg.norm, cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (cfg.d_model, cfg.vocab), 0.02,
                                        dtype, device)
    return params


class LM(nn.Module):
    """Decoder-only LM: embed → layers → final norm → unembed (tied:
    ``x @ embed.T``).

    ``moe_stats``: ``None``, or a dict into which every MoE layer of a
    :meth:`decode_step` adds its (token, slot) selections (``"selected"``)
    and the ones its capacity dropped (``"dropped"``, on the device until
    read)."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.moe_stats: dict | None = None
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.layers = nn.ModuleList(ParamTree(p) for p in params["layers"])
        self.kinds = [layer_kind(cfg, i) for i in range(cfg.n_layers)]
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
        caches, stacked by pattern position, when ``return_cache``).
        ``use_kernel=False`` runs the plain attention instead of the
        flash-attention kernel."""
        cfg = self.cfg
        x = self.embed_inputs(tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        caches = []
        for kind, layer in zip(self.kinds, self.layers):
            x, c = block_forward(layer, cfg, kind, x, positions, use_kernel)
            if return_cache:
                caches.append(c)
        x = make_norm(cfg.norm)(self.final_norm, x)
        logits = self.unembed(x)
        if return_cache:
            return logits, _stack_caches(cfg, caches)
        return logits

    def decode_step(self, tokens: torch.Tensor, cache, pos: int):
        """One-token decode.  tokens: [B, 1]; ``cache`` from
        :func:`init_cache` or ``prefill_to_decode_cache`` (updated in place);
        ``pos``: tokens so far.  Returns (logits [B, V], cache)."""
        cfg = self.cfg
        groups, extra = cache
        L = len(cfg.pattern)
        n_grouped = len(self.layers) - len(extra)
        x = self.embed_inputs(tokens)
        for i, (kind, layer) in enumerate(zip(self.kinds, self.layers)):
            if i < n_grouped:
                g, j = divmod(i, L)
                layer_cache = {name: t[g] for name, t in groups[j].items()}
            else:
                layer_cache = extra[i - n_grouped]
            x = block_decode(layer, cfg, kind, x, layer_cache, pos, self.moe_stats)
        x = make_norm(cfg.norm)(self.final_norm, x)
        return self.unembed(x)[:, 0], cache


def _stack_caches(cfg, caches: list[dict]):
    """Per-layer cache entries → ``(groups, extra)``: per pattern position,
    its layers' entries stacked over the groups; the remainder blocks'
    entries as they are."""
    L = len(cfg.pattern)
    n_groups = len(caches) // L
    groups = tuple({name: torch.stack([caches[g * L + j][name]
                                       for g in range(n_groups)])
                    for name in caches[j]} for j in range(L))
    return groups, tuple(caches[n_groups * L:])


def init_lm(cfg, seed: int = 0, dtype=torch.bfloat16, device="cuda") -> LM:
    """A randomly initialised :class:`LM` on ``device`` (the card unless
    ``device="cpu"``), drawn from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, init_params(cfg, gen, dtype, dev))


def init_cache(cfg, batch: int, ctx_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """Empty decode caches ``(groups, extra)`` in the reference's layout:
    per pattern position an entry stacked over the groups, then one per
    remainder block.  Attention: k/v ``[.., batch, clen, Hkv, Dh]`` in
    ``dtype``, slot_pos ``[.., clen]`` = -1, clen = ``min(ctx_len,
    window)``; a recurrent block's state is float32 zeros
    (:func:`repro_torch.models.ssm.recurrent_cache`)."""
    check_supported(cfg)
    dev = resolve_device(device)
    n_groups, n_extra = divmod(cfg.n_layers, len(cfg.pattern))
    clen = min(ctx_len, cfg.window) if cfg.window else ctx_len

    def one(kind, lead):
        if kind != "attn":
            return recurrent_cache(cfg, kind, batch, lead, dev)
        shape = lead + (batch, clen, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "slot_pos": torch.full(lead + (clen,), -1, dtype=torch.int32,
                                       device=dev)}

    return (tuple(one(kind, (n_groups,)) for kind in cfg.pattern),
            tuple(one(cfg.pattern[e], ()) for e in range(n_extra)))
