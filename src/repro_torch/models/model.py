"""The LM (port of ``repro/models/model.py``): token inputs, or the
embeddings of a stub frontend (``embed_input=False``: musicgen-medium,
phi-3-vision-4.2b; no ``embed``, an ``lm_head``); layers of the
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

Training: :func:`loss_fn` (next-token cross-entropy, optionally masked and
streamed over sequence chunks) over ``LM.forward`` with ``remat`` (each
pattern group and each remainder block under ``torch.utils.checkpoint``,
the reference's ``jax.checkpoint``) and ``return_hidden``.  Parameters are
frozen unless the model is made with ``init_lm(trainable=True)`` (or
``requires_grad_(True)``); the flash kernel has no backward, so a trainable
forward runs with ``use_kernel=False``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..device import resolve_device
from ..core.nap_collectives import (from_local, group_reduce,
                                    group_sum_replicated, local_region,
                                    partial, replicate, shard, summed_grad)
from .act_sharding import (constrain, constrain_q5, constrain_residual,
                           constrain_scores, current, settle, settle_heads)
from .attention import _project_qkv, attn_forward, attn_params
from .layers import (apply_rope, make_norm, mlp, mlp_params, norm_params,
                     normal_init, wide)
from .moe import moe_ep_shardmap, moe_ffn_tp, moe_params
from .ssm import PARAMS as RECURRENT_PARAMS
from .ssm import recurrent_cache, recurrent_decode, recurrent_forward

NEG_INF = -1e30


KINDS = ("attn", *RECURRENT_PARAMS)


def check_supported(cfg) -> None:
    """Raise ``ValueError`` for a block kind the reference does not have."""
    unknown = sorted(set(cfg.pattern) - set(KINDS))
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {unknown}; the "
                         f"kinds are {KINDS}")


class ParamTree(nn.Module):
    """A nested parameter dict as a module: tensors become (frozen)
    parameters, dicts become submodules, and ``p[name]`` reads either, so
    the layer functions index it as they index the reference's pytree.
    ``requires_grad_(True)`` makes them trainable."""

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


def layer_slot(cfg, i: int) -> tuple[int | None, int]:
    """Where layer ``i`` sits in the reference's stacked tree: ``(g, j)``,
    group ``g`` at pattern position ``j``, for a layer inside a pattern
    group; ``(None, e)`` for the remainder block ``extra[e]``."""
    L = len(cfg.pattern)
    n_grouped = (cfg.n_layers // L) * L
    if i < n_grouped:
        return divmod(i, L)
    return None, i - n_grouped


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
        ep = current("moe_ep")
        if ep is not None:
            return moe_ep_shardmap(p["ffn"], cfg, x, **ep)
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
        cache = {k: _batch_only(t) for k, t in cache.items()}
    x = x + settle(out)
    if _has_ffn(cfg, kind):
        x = x + settle(_ffn_apply(p, cfg, norm(p["ln2"], x)))
    return constrain_residual(x), cache


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
    _write_slot(cache_k, k[:, 0], slot)
    _write_slot(cache_v, v[:, 0], slot)
    _write_slot(slot_pos, pos, slot, dim=0)
    group = cfg.n_heads // cfg.n_kv_heads
    if isinstance(q, DTensor):
        # split heads into (kv head, group) rank by rank only where the
        # heads are whole: move a head sharding to q5's head-dim one
        spec = current("q5_spec")
        spec = (spec[0], spec[1], None, spec[4]) if spec else ()
        q = constrain(q, spec) if spec else settle_heads(q)
    q5 = q.reshape(b, 1, cfg.n_kv_heads, group, cfg.head_dim)
    q5 = constrain_q5(q5)     # reshard the tiny q, never the cache
    # float32 scores (the reference's preferred_element_type)
    s = _decode_scores(q5, cache_k) * cfg.head_dim ** -0.5
    s = constrain_scores(s)   # the dh contraction completes with a sum
    mask = (slot_pos <= pos) & (slot_pos >= 0)
    if cfg.window is not None:
        mask &= slot_pos > pos - cfg.window
    s = torch.where(mask, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = _decode_values(pr.to(cache_v.dtype), cache_v)
    out = out.to(x.dtype).reshape(b, 1, -1)
    return out @ p["wo"]


def _copy_state(dst, src):
    """A recurrent state written into its cache entry in place (a DTensor
    state first takes the entry's placements)."""
    if isinstance(dst, DTensor):
        if not isinstance(src, DTensor):
            raise TypeError("a DTensor cache entry needs a DTensor state")
        src = src.redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
        return
    dst.copy_(src)


def _embed_sharded(table, ids):
    """Embedding lookup from a DTensor table: where its vocab dim is sharded
    (over one mesh dim) each rank looks up the ids in its slice, zeros
    elsewhere, and one all-reduce over that dim completes the rows (the
    vocab-parallel lookup GSPMD makes of the reference's ``jnp.take``).
    The table's gradient is summed over the dims the ids are sharded
    over."""
    from torch.distributed.tensor import Shard
    mesh = table.device_mesh
    tp = tuple(table.placements)
    v_dims = [i for i, p in enumerate(tp)
              if isinstance(p, Shard) and p.dim == 0]
    ip = tuple(ids.placements) if isinstance(ids, DTensor) else \
        tuple(replicate() for _ in tp)
    part = tuple(partial() if i in v_dims else p for i, p in enumerate(ip))
    coord = [mesh.get_local_rank(i) for i in v_dims]
    if len(v_dims) > 1:
        raise ValueError(f"embedding: vocab sharded over {len(v_dims)} dims")

    def body(t, i):
        if not v_dims:
            return F.embedding(i, t)
        lo = coord[0] * t.shape[0]
        li = i.long() - lo
        mine = (li >= 0) & (li < t.shape[0])
        rows = F.embedding(li.clamp(0, t.shape[0] - 1), t)
        return torch.where(mine[..., None], rows,
                           torch.zeros((), dtype=t.dtype, device=t.device))

    x = local_region(body, list(part), (tp, ip), mesh,
                     redistribute_inputs=True,
                     in_grad_placements=(summed_grad(tp, ip), ip))(table, ids)
    return x.redistribute(mesh, list(ip))


def _write_slot(cache, value, slot: int, dim: int = 1):
    """``cache``'s slot ``slot`` along ``dim`` set to ``value`` in place.  A
    DTensor cache is written rank by rank: ``value`` is first
    redistributed to the cache's placements (the slot dim dropped), which
    for a replicated value is a local slice."""
    if not isinstance(cache, DTensor):
        dst = cache.select(dim, slot)
        dst.copy_(value) if torch.is_tensor(value) else dst.fill_(value)
        return
    from torch.distributed.tensor import Shard
    place = tuple(shard(p.dim - (p.dim > dim)) if isinstance(p, Shard)
                  else replicate() for p in cache.placements)
    if not isinstance(value, DTensor):
        value = torch.as_tensor(value, dtype=cache.dtype)
        cache.to_local().select(dim, slot).fill_(value)
        return
    value = value.redistribute(cache.device_mesh, place)
    cache.to_local().select(dim, slot).copy_(value.to_local())


def _decode_scores(q5, cache_k):
    """``einsum("bqhgd,bkhd->bhgqk")`` in float32.  On DTensors with the
    head dim sharded over a mesh dim (the cache's layout) each rank
    contracts its share and the scores are a pending sum over that dim."""
    if not isinstance(q5, DTensor):
        return torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), cache_k.float())
    from torch.distributed.tensor import Shard
    kp = tuple(cache_k.placements)
    qp = tuple(shard(4) if isinstance(p, Shard) and p.dim == 3 else p
               for p in kp)
    out = tuple(partial() if isinstance(p, Shard) and p.dim == 3
                else p if isinstance(p, Shard) and p.dim == 0 else replicate()
                for p in kp)
    def body(a, c):
        return torch.einsum("bqhgd,bkhd->bhgqk", a.float(), c.float())

    return local_region(body, list(out), (qp, kp), q5.device_mesh,
                        redistribute_inputs=True)(q5, cache_k)


def _decode_values(pr, cache_v):
    """``einsum("bhgqk,bkhd->bqhgd")``; on DTensors the output keeps the
    cache's head-dim sharding, then is gathered whole over it (a small
    [B, 1, H, dh] tensor) for the output projection."""
    if not isinstance(pr, DTensor):
        return torch.einsum("bhgqk,bkhd->bqhgd", pr, cache_v)
    from torch.distributed.tensor import Shard
    kp = tuple(cache_v.placements)
    pp = tuple(p if isinstance(p, Shard) and p.dim == 0 else replicate()
               for p in kp)
    op = tuple(shard(4) if isinstance(p, Shard) and p.dim == 3 else p
               for p in kp)
    def body(a, c):
        return torch.einsum("bhgqk,bkhd->bqhgd", a, c)

    out = local_region(body, list(op), (pp, kp), pr.device_mesh,
                       redistribute_inputs=True)(pr, cache_v)
    return out.redistribute(out.device_mesh, pp)


def block_decode(p, cfg, kind: str, x, cache: dict, pos: int,
                 moe_stats: dict | None = None):
    """One token through one block; ``cache`` (this layer's entry, views
    of the stacked caches) is updated in place."""
    norm = make_norm(cfg.norm)
    h = norm(p["ln1"], x)
    if kind == "attn":
        x = x + settle(attn_decode_cached(p["core"], cfg, h, cache, pos))
    else:
        out, new = recurrent_decode(p["core"], cfg, kind, h, cache)
        for name, t in new.items():
            _copy_state(cache[name], t)
        x = x + settle(out)
    if _has_ffn(cfg, kind):
        x = x + settle(_ffn_apply(p, cfg, norm(p["ln2"], x), moe_stats))
    return x


def init_params(cfg, gen: torch.Generator, dtype, device) -> dict:
    """Random parameters at the reference's scales (normal × fan_in^-0.5 for
    projections, 0.02 for embed and head, ones/zeros for norms and biases):
    ``{["embed",] "layers": [block...], "final_norm"[, "lm_head"]}``: no
    ``embed`` where ``embed_input=False``, an ``lm_head`` unless the
    embedding is tied."""
    check_supported(cfg)
    params = {}
    if cfg.embed_input:
        params["embed"] = normal_init(gen, (cfg.vocab, cfg.d_model), 0.02,
                                      dtype, device)
    params["layers"] = [block_params(gen, cfg, layer_kind(cfg, i), dtype, device)
                        for i in range(cfg.n_layers)]
    params["final_norm"] = norm_params(cfg.norm, cfg.d_model, dtype, device)
    if not (cfg.tie_embeddings and cfg.embed_input):
        params["lm_head"] = normal_init(gen, (cfg.d_model, cfg.vocab), 0.02,
                                        dtype, device)
    return params


class LM(nn.Module):
    """Decoder-only LM: embed (or the frontend's embeddings) → layers →
    final norm → unembed (tied: ``x @ embed.T``, else ``x @ lm_head``).

    ``moe_stats``: ``None``, or a dict into which every MoE layer of a
    :meth:`decode_step` adds its (token, slot) selections (``"selected"``)
    and the ones its capacity dropped (``"dropped"``, on the device until
    read).  The parameters are frozen (serving); ``requires_grad_(True)``
    makes them trainable."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.moe_stats: dict | None = None
        self.embed = (nn.Parameter(params["embed"], requires_grad=False)
                      if "embed" in params else None)
        self.layers = nn.ModuleList(ParamTree(p) for p in params["layers"])
        self.kinds = [layer_kind(cfg, i) for i in range(cfg.n_layers)]
        self.final_norm = ParamTree(params["final_norm"])
        self.lm_head = (nn.Parameter(params["lm_head"], requires_grad=False)
                        if "lm_head" in params else None)

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    @property
    def dtype(self) -> torch.dtype:
        """The type of the weights (the norm scales')."""
        return self.final_norm["scale"].dtype

    def embed_inputs(self, inputs: torch.Tensor) -> torch.Tensor:
        """Tokens ``[B, S]`` → their embeddings; where ``embed_input=False``
        the inputs are the frontend's embeddings ``[B, S, d]`` already, and
        go on in the weights' type (the reference's type promotion would
        widen the activations instead; torch's products want one type)."""
        if self.cfg.embed_input:
            if isinstance(self.embed, DTensor):
                return _embed_sharded(self.embed, inputs)
            return F.embedding(inputs, self.embed)
        return inputs.to(self.dtype)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return x @ self.embed.T
        return x @ self.lm_head

    def _groups(self):
        """The layers as (kinds, layers) runs: one per pattern group, then
        one per remainder block (the units ``remat`` checkpoints)."""
        runs: dict = {}
        for i, (kind, layer) in enumerate(zip(self.kinds, self.layers)):
            g, j = layer_slot(self.cfg, i)
            kinds, layers = runs.setdefault(g if g is not None else ("extra", j),
                                            ([], []))
            kinds.append(kind)
            layers.append(layer)
        return list(runs.values())

    def forward(self, inputs: torch.Tensor, return_cache: bool = False,
                use_kernel: bool = True, remat: bool = False,
                return_hidden: bool = False):
        """Train / prefill forward.  inputs: tokens [B, S] (or embeddings
        [B, S, d] where ``embed_input=False``) → logits [B, S, V] (and the
        caches, stacked by pattern position, when ``return_cache``).
        ``use_kernel=False`` runs the plain attention (or
        :func:`~repro_torch.models.attention.chunked_attention` past 1024
        positions) instead of the flash-attention kernel; ``remat`` runs
        each pattern group and each remainder block under
        ``torch.utils.checkpoint`` (recomputed in the backward);
        ``return_hidden`` returns the final-normed hidden state [B, S, d]
        instead of the logits."""
        cfg = self.cfg
        x = self.embed_inputs(inputs)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        caches = []

        def run(x, kinds, layers):
            out = []
            for kind, layer in zip(kinds, layers):
                x, c = block_forward(layer, cfg, kind, x, positions, use_kernel)
                out.append(c if return_cache else None)
            return x, out

        for kinds, layers in self._groups():
            if remat and torch.is_grad_enabled():
                x, c = checkpoint(run, x, kinds, layers, use_reentrant=False)
            else:
                x, c = run(x, kinds, layers)
            caches += c
        x = make_norm(cfg.norm)(self.final_norm, x)
        if return_hidden:
            return x
        logits = self.unembed(x)
        if return_cache:
            return logits, _stack_caches(cfg, caches)
        return logits

    def decode_step(self, tokens: torch.Tensor, cache, pos: int):
        """One-token decode.  tokens: [B, 1] (embeddings [B, 1, d] where
        ``embed_input=False``); ``cache`` from
        :func:`init_cache` or ``prefill_to_decode_cache`` (updated in place);
        ``pos``: tokens so far.  Returns (logits [B, V], cache)."""
        cfg = self.cfg
        groups, extra = cache
        x = self.embed_inputs(tokens)
        for i, (kind, layer) in enumerate(zip(self.kinds, self.layers)):
            g, j = layer_slot(cfg, i)
            layer_cache = (extra[j] if g is None else
                           {name: t[g] for name, t in groups[j].items()})
            x = block_decode(layer, cfg, kind, x, layer_cache, pos, self.moe_stats)
        x = make_norm(cfg.norm)(self.final_norm, x)
        return self.unembed(x)[:, 0], cache


def _stack_caches(cfg, caches: list[dict]):
    """Per-layer cache entries → ``(groups, extra)``: per pattern position,
    its layers' entries stacked over the groups; the remainder blocks'
    entries as they are."""
    L = len(cfg.pattern)
    n_groups = len(caches) // L
    groups = tuple({name: _stack([caches[g * L + j][name]
                                  for g in range(n_groups)])
                    for name in caches[j]} for j in range(L))
    return groups, tuple(caches[n_groups * L:])


def _batch_only(t):
    """A DTensor recurrent state in its cache layout (the cache specs':
    batch over dp, whole otherwise); anything else as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [
        p if getattr(p, "dim", None) == 0 else replicate()
        for p in t.placements])


def _stack(ts: list):
    """``torch.stack``; DTensors of one layout are stacked rank by rank (a
    new leading dim, their shardings one dim on), with no collective."""
    if not isinstance(ts[0], DTensor) or any(
            tuple(t.placements) != tuple(ts[0].placements) for t in ts):
        return torch.stack(ts)
    from torch.distributed.tensor import Shard
    pl = [shard(p.dim + 1) if isinstance(p, Shard) else p
          for p in ts[0].placements]
    return from_local(torch.stack([t.to_local() for t in ts]),
                      ts[0].device_mesh, pl)


def init_lm(cfg, seed: int = 0, dtype=torch.bfloat16, device="cuda",
            trainable: bool = False) -> LM:
    """A randomly initialised :class:`LM` on ``device`` (the card unless
    ``device="cpu"``), drawn from a ``torch.Generator`` seeded with ``seed``;
    its parameters require grad when ``trainable``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, init_params(cfg, gen, dtype, dev)).requires_grad_(trainable)


def _xent_sharded(logits, tgt):
    """:func:`_xent` on DTensor logits whose vocab dim is sharded over one
    mesh dim (a vocab-parallel head): each rank's max, sum of exponentials
    and target logit over its vocab slice, each completed by one all-reduce
    over that dim (``[B, S]`` floats), as GSPMD lowers the reference's."""
    from torch.distributed.tensor import Shard

    mesh, vd = logits.device_mesh, logits.ndim - 1
    lp = tuple(logits.placements)
    v_dims = [i for i, p in enumerate(lp)
              if isinstance(p, Shard) and p.dim == vd]
    if len(v_dims) > 1:
        raise ValueError(f"_xent: vocab sharded over {len(v_dims)} mesh dims")
    out_pl = tuple(p if isinstance(p, Shard) and p.dim < vd else replicate()
                   for p in lp)
    group = mesh.get_group(v_dims[0]) if v_dims else None
    coord = mesh.get_local_rank(v_dims[0]) if v_dims else 0

    def body(lg, t):
        lg = wide(lg)
        if group is None:
            return _xent(lg, t)
        off = coord * lg.shape[-1]
        m = group_reduce(lg.detach().amax(-1), "max", group)
        se = group_sum_replicated(torch.exp(lg - m[..., None]).sum(-1), group)
        lt = t.long() - off
        mine = (lt >= 0) & (lt < lg.shape[-1])
        gold = torch.gather(lg, -1, lt.clamp(0, lg.shape[-1] - 1)[..., None])
        gold = group_sum_replicated(torch.where(mine, gold[..., 0], 0.0),
                                    group)
        return m + torch.log(se) - gold

    return local_region(body, list(out_pl), (lp, out_pl), mesh,
                        redistribute_inputs=True)(logits, tgt)


def _xent(logits: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood of ``tgt`` in float32 (float64
    for a float64 model)."""
    if isinstance(logits, DTensor):
        return _xent_sharded(logits, tgt)
    logits = wide(logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None].long())[..., 0]
    return lse - gold


def _chunk_nll(model, xc, tc, mc):
    nll = _xent(model.unembed(xc), tc)
    return (nll * mc).sum(), mc.sum()


def loss_fn(model: LM, cfg, batch: dict, use_kernel: bool = False,
            remat: bool = False, loss_chunk: int | None = None) -> torch.Tensor:
    """Next-token cross-entropy (port of the reference's ``loss_fn``).
    batch: ``{"inputs": tokens | embeddings, "targets": [B, S] int, "mask":
    [B, S] (optional)}``; the mean over the positions (masked: over the mask's
    sum, at least 1).

    ``loss_chunk``: the unembed and log-sum-exp stream over sequence chunks
    of that length (each under ``torch.utils.checkpoint`` when grad mode is
    on, as the reference's ``jax.checkpoint``), so the [B, S, V] logits
    never exist at once; it must divide S."""
    tgt = batch["targets"]
    mask = batch.get("mask")
    if loss_chunk is None:
        logits = model(batch["inputs"], use_kernel=use_kernel, remat=remat)
        nll = _xent(logits, tgt)
        if mask is not None:
            mask = mask.to(nll.dtype)
            return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return nll.mean()
    x = model(batch["inputs"], use_kernel=use_kernel, remat=remat,
              return_hidden=True)
    B, S, d = x.shape
    c = min(loss_chunk, S)
    if S % c:
        raise ValueError(f"loss_chunk {loss_chunk} must divide seq_len {S}")
    acc = torch.promote_types(x.dtype, torch.float32)
    mask = (torch.ones((B, S), dtype=acc, device=x.device)
            if mask is None else mask.to(acc))
    tot = torch.zeros((), dtype=acc, device=x.device)
    cnt = torch.zeros((), dtype=acc, device=x.device)
    for i in range(0, S, c):
        args = (model, x[:, i:i + c], tgt[:, i:i + c], mask[:, i:i + c])
        s_nll, s_cnt = (checkpoint(_chunk_nll, *args, use_reentrant=False)
                        if torch.is_grad_enabled() else _chunk_nll(*args))
        tot, cnt = tot + s_nll, cnt + s_cnt
    return tot / torch.clamp(cnt, min=1.0)


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
