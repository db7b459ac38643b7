"""Recurrent blocks of the LM stack (port of ``repro/models/ssm.py``):
xLSTM's mLSTM and sLSTM, and RecurrentGemma's RG-LRU.

* mLSTM: chunkwise gated linear attention.  Within a chunk of ``L =
  min(chunk, S)`` steps it is quadratic (a decay matrix with ``-inf`` above
  the diagonal); across chunks it carries the matrix state ``C [B, H, Dk,
  Dv]`` and the normaliser state ``n [B, H, Dk]``.  Sigmoid input and
  forget gates, as in the reference.
* sLSTM: a sequential loop over time (the reference's ``lax.scan``) with
  per-head recurrent mixing ``rh [H, dh, 4 dh]``; state ``(h [B, d], c, n
  [B, H, dh])``.
* RG-LRU: a depthwise causal conv of width 4 (3 steps of state), then the
  diagonal recurrence ``h_t = a_t h_{t-1} + b_t`` as a log-depth parallel
  prefix (:func:`linear_scan`), gated by a tanh-approximated GELU.

Each block has a forward over a sequence that returns its final state and
a one-token decode step from a carried state, with the same parameters.

None of these is a Pallas kernel in the reference (they are ``lax.scan``
and ``associative_scan``), so they are plain torch here and run on whatever
device their tensors lie on.  Between the projections the reference works
in float32; here in ``torch.promote_types(x.dtype, float32)`` (:func:`_acc`):
float32 for bfloat16 and float32 inputs, as the reference, and float64 for
float64 inputs, so the same code gives a float64 truth.

A property of the reference kept on purpose: :func:`mlstm_forward` zero-pads
S up to a multiple of the chunk, and the state it returns has run through
the pad steps.  A zero input still gives ``log σ(f_bias) = log σ(3)``, so
every pad step decays ``C`` and ``n`` (the outputs are right; only the
state handed to decode is small).  The port is held to the reference and
does the same.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense_init, normal_init

MLSTM_CHUNK = 256
F_BIAS = 3.0       # the forget gates' initial bias: start remembering
RG_C = 8.0         # RG-LRU: a = sigmoid(lam) ** (RG_C * r)
RG_LAM = 2.0
CONV_WIDTH = 4


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The arithmetic type between the projections."""
    return torch.promote_types(dtype, torch.float32)


# ------------------------------------------------------------------ mLSTM
def mlstm_params(gen, cfg, dtype, device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    return {"wq": dense_init(gen, d, (d, d), dtype, device),
            "wk": dense_init(gen, d, (d, d), dtype, device),
            "wv": dense_init(gen, d, (d, d), dtype, device),
            "wi": dense_init(gen, d, (d, h), dtype, device),   # input gate, per head
            "wf": dense_init(gen, d, (d, h), dtype, device),   # forget gate, per head
            "wo": dense_init(gen, d, (d, d), dtype, device),
            "f_bias": torch.full((h,), F_BIAS, dtype=dtype, device=device)}


def _mlstm_chunk(C, n, q, k, v, logf, i, dh: int):
    """One chunk.  C [B, H, Dk, Dv], n [B, H, Dk]; q, k, v [B, L, H, Dh]
    and logf, i [B, L, H], all in the arithmetic type.  Returns (C, n,
    h [B, L, H, Dh])."""
    L = q.shape[1]
    cum = torch.cumsum(logf, dim=1)                       # [B, L, H]
    tot = cum[:, -1]                                      # [B, H]
    # decay D[j, i] = exp(cum_j - cum_i) * i_i for i <= j
    dm = cum[:, :, None, :] - cum[:, None, :, :]          # [B, j, i, H]
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    dm = torch.where(tri[None, :, :, None], dm, -torch.inf)
    w = torch.exp(dm) * i[:, None, :, :]
    scale = dh ** -0.5
    sw = torch.einsum("bjhd,bihd->bjih", q, k) * scale * w
    intra = torch.einsum("bjih,bihd->bjhd", sw, v)
    # the carried state's contribution
    qs = q * torch.exp(cum)[..., None] * scale
    inter = torch.einsum("bjhk,bhkd->bjhd", qs, C)
    norm = torch.einsum("bjhk,bhk->bjh", qs, n) + sw.sum(dim=2)
    h = (intra + inter) / torch.clamp(norm.abs(), min=1.0)[..., None]
    # the state after the chunk
    decay = torch.exp(tot[:, None, :] - cum) * i          # [B, L, H]
    kd = k * decay[..., None]
    C = torch.exp(tot)[..., None, None] * C + torch.einsum("bihd,bihe->bhde", kd, v)
    n = torch.exp(tot)[..., None] * n + kd.sum(dim=1)
    return C, n, h


def mlstm_forward(p, cfg, x: torch.Tensor, chunk: int = MLSTM_CHUNK, state=None):
    """x: [B, S, d] → ([B, S, d], (C, n)).  S is zero-padded to a multiple
    of the chunk, and the returned state has run through the pad steps."""
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    Sp = S + pad
    acc = _acc(x.dtype)
    q, k, v = ((x @ p[w]).reshape(B, Sp, H, dh).to(acc) for w in ("wq", "wk", "wv"))
    i = torch.sigmoid((x @ p["wi"]).to(acc))
    logf = F.logsigmoid((x @ p["wf"]).to(acc) + p["f_bias"].to(acc))
    if state is None:
        state = (torch.zeros((B, H, dh, dh), dtype=acc, device=x.device),
                 torch.zeros((B, H, dh), dtype=acc, device=x.device))
    C, n = state
    hs = []
    for c in range(Sp // L):
        sl = slice(c * L, (c + 1) * L)
        C, n, h = _mlstm_chunk(C, n, q[:, sl], k[:, sl], v[:, sl], logf[:, sl],
                               i[:, sl], dh)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, Sp, d)[:, :S]
    return h.to(x.dtype) @ p["wo"], (C, n)


def mlstm_decode(p, cfg, x: torch.Tensor, state):
    """x: [B, 1, d]; state (C, n) → ([B, 1, d], (C, n))."""
    B, _, d = x.shape
    H = cfg.n_heads
    dh = d // H
    acc = _acc(x.dtype)
    C, n = state
    q, k, v = ((x @ p[w]).reshape(B, H, dh).to(acc) for w in ("wq", "wk", "wv"))
    i = torch.sigmoid((x @ p["wi"]).to(acc)).reshape(B, H)
    f = torch.sigmoid((x @ p["wf"]).to(acc) + p["f_bias"].to(acc)).reshape(B, H)
    C = f[..., None, None] * C + i[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v)
    n = f[..., None] * n + i[..., None] * k
    qs = q * dh ** -0.5
    num = torch.einsum("bhd,bhde->bhe", qs, C)
    den = torch.clamp(torch.einsum("bhd,bhd->bh", qs, n).abs(), min=1.0)
    h = (num / den[..., None]).reshape(B, 1, d).to(x.dtype)
    return h @ p["wo"], (C, n)


# ------------------------------------------------------------------ sLSTM
def slstm_params(gen, cfg, dtype, device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    return {"wx": dense_init(gen, d, (d, 4 * d), dtype, device),       # i, f, z, o from x
            "rh": dense_init(gen, dh, (h, dh, 4 * dh), dtype, device),  # recurrent, per head
            "bias": torch.zeros((4 * d,), dtype=dtype, device=device),
            "out": dense_init(gen, d, (d, d), dtype, device)}


def _slstm_step(rh, xt, state):
    """xt: [B, d] gate inputs in the arithmetic type; rh [H, dh, 4 dh] in
    it too; state (h [B, d], c, n [B, H, dh])."""
    h_prev, c_prev, n_prev = state
    B = xt.shape[0]
    H, dh = rh.shape[0], rh.shape[1]
    rec = torch.einsum("bhd,hde->bhe", h_prev.reshape(B, H, dh), rh)
    gates = xt.reshape(B, H, 4 * dh) + rec
    i, f, z, o = gates.split(dh, dim=-1)
    i = torch.exp(torch.clamp(i, max=0.0))     # bounded exponential gate
    f = torch.sigmoid(f + F_BIAS)
    c = f * c_prev + i * torch.tanh(z)
    n = f * n_prev + i
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
    return h.reshape(B, -1), c, n


def slstm_forward(p, cfg, x: torch.Tensor, state=None):
    """x: [B, S, d] → ([B, S, d], (h, c, n)): one step a token."""
    B, S, d = x.shape
    H = cfg.n_heads
    acc = _acc(x.dtype)
    xg = (x @ p["wx"] + p["bias"]).to(acc)
    if state is None:
        state = (torch.zeros((B, d), dtype=acc, device=x.device),
                 torch.zeros((B, H, d // H), dtype=acc, device=x.device),
                 torch.zeros((B, H, d // H), dtype=acc, device=x.device))
    rh = p["rh"].to(acc)
    hs = torch.empty((B, S, d), dtype=acc, device=x.device)
    for t in range(S):
        state = _slstm_step(rh, xg[:, t], state)
        hs[:, t] = state[0]
    return hs.to(x.dtype) @ p["out"], state


def slstm_decode(p, cfg, x: torch.Tensor, state):
    xg = (x @ p["wx"] + p["bias"])[:, 0].to(_acc(x.dtype))
    h, c, n = _slstm_step(p["rh"].to(xg.dtype), xg, state)
    return h[:, None].to(x.dtype) @ p["out"], (h, c, n)


# ------------------------------------------------------------------ RG-LRU
def rglru_params(gen, cfg, dtype, device) -> dict:
    """``lam`` stays float32 whatever ``dtype`` is, as in the reference."""
    d = cfg.d_model
    return {"in_x": dense_init(gen, d, (d, d), dtype, device),
            "in_gate": dense_init(gen, d, (d, d), dtype, device),
            "conv": normal_init(gen, (CONV_WIDTH, d), 0.1, dtype, device),
            "wa": dense_init(gen, d, (d, d), dtype, device),   # recurrence gate
            "wi": dense_init(gen, d, (d, d), dtype, device),   # input gate
            "lam": torch.full((d,), RG_LAM, dtype=torch.float32, device=device),
            "out": dense_init(gen, d, (d, d), dtype, device)}


def _rg_gates(p, u: torch.Tensor):
    """u: [B, S, d] (the conv's output) → (a, b) of the recurrence."""
    acc = _acc(u.dtype)
    r = torch.sigmoid((u @ p["wa"]).to(acc))
    i = torch.sigmoid((u @ p["wi"]).to(acc))
    log_a = RG_C * r * F.logsigmoid(p["lam"].to(acc))
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, beta * i * u.to(acc)


def _causal_conv(p, u: torch.Tensor, state=None):
    """Depthwise causal conv of width 4 over time.  u: [B, S, d]; state: the
    last 3 inputs [B, 3, d] (in the arithmetic type).  Returns (the output
    in ``u.dtype``, the new state: the last 3 inputs in the arithmetic
    type)."""
    acc = _acc(u.dtype)
    w = p["conv"].to(acc)
    B, S, d = u.shape
    if state is None:
        pads = torch.zeros((B, CONV_WIDTH - 1, d), dtype=u.dtype, device=u.device)
    else:
        pads = state.to(u.dtype)
    ext = torch.cat([pads, u], dim=1).to(acc)
    # the reference's sum over taps, in its order: tap t reads ext shifted by t
    out = ext[:, 3:3 + S] * w[3]
    for t in range(1, CONV_WIDTH):
        out = out + ext[:, 3 - t:3 - t + S] * w[3 - t]
    return out.to(u.dtype), ext[:, -(CONV_WIDTH - 1):].clone()


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over dim 1, h_{-1} = 0: a Hillis-Steele
    prefix with the reference's combine ``(a_l a_r, a_r b_l + b_r)``, in
    ceil(log2 S) steps of whole-tensor operations.  Its summation order is
    not ``associative_scan``'s, so the two agree to rounding, not bit for
    bit."""
    S = a.shape[1]
    shift = 1
    while shift < S:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift] + b[:, shift:]], dim=1)
        if 2 * shift < S:
            a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return b


def rglru_forward(p, cfg, x: torch.Tensor, state=None):
    """Recurrent block: (conv → RG-LRU) ⊙ gelu gate → out.  x: [B, S, d] →
    ([B, S, d], {"conv": [B, 3, d], "h": [B, d]}); ``state`` of the same
    form carries a conv history and an ``h`` added at step 0."""
    u = x @ p["in_x"]
    gate = F.gelu((x @ p["in_gate"]).to(_acc(x.dtype)), approximate="tanh")
    u, conv_state = _causal_conv(p, u, None if state is None else state["conv"])
    a, b = _rg_gates(p, u)
    if state is not None:
        b[:, 0] += a[:, 0] * state["h"]
    h = linear_scan(a, b)
    y = (h * gate).to(x.dtype) @ p["out"]
    return y, {"conv": conv_state, "h": h[:, -1].clone()}


def rglru_decode(p, cfg, x: torch.Tensor, state):
    u = x @ p["in_x"]
    gate = F.gelu((x @ p["in_gate"]).to(_acc(x.dtype)), approximate="tanh")
    u, conv_state = _causal_conv(p, u, state["conv"])
    a, b = _rg_gates(p, u)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = (h[:, None] * gate).to(x.dtype) @ p["out"]
    return y, {"conv": conv_state, "h": h}


# ---------------------------------------------------------- block dispatch
PARAMS = {"mlstm": mlstm_params, "slstm": slstm_params, "rglru": rglru_params}
# each kind's state as (forward/decode state) <-> cache entry names
STATE_NAMES = {"mlstm": ("C", "n"), "slstm": ("h", "c", "n")}


def recurrent_forward(p, cfg, kind: str, x: torch.Tensor):
    """The block of ``kind`` over a sequence: (out, cache entry)."""
    if kind == "mlstm":
        out, st = mlstm_forward(p, cfg, x)
    elif kind == "slstm":
        out, st = slstm_forward(p, cfg, x)
    else:
        return rglru_forward(p, cfg, x)
    return out, dict(zip(STATE_NAMES[kind], st))


def recurrent_decode(p, cfg, kind: str, x: torch.Tensor, cache: dict):
    """One token of the block of ``kind`` from its cache entry: (out, new
    cache entry)."""
    if kind == "rglru":
        return rglru_decode(p, cfg, x, cache)
    fn = mlstm_decode if kind == "mlstm" else slstm_decode
    out, st = fn(p, cfg, x, tuple(cache[name] for name in STATE_NAMES[kind]))
    return out, dict(zip(STATE_NAMES[kind], st))


def recurrent_cache(cfg, kind: str, batch: int, lead=(), device=None) -> dict:
    """An empty cache entry of ``kind`` (zeros, float32 as in the
    reference), with ``lead`` dims in front (the stacked groups)."""
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    shapes = {"mlstm": {"C": (batch, H, hd, hd), "n": (batch, H, hd)},
              "slstm": {"h": (batch, d), "c": (batch, H, hd), "n": (batch, H, hd)},
              "rglru": {"conv": (batch, CONV_WIDTH - 1, d), "h": (batch, d)}}[kind]
    return {name: torch.zeros(tuple(lead) + s, dtype=torch.float32, device=device)
            for name, s in shapes.items()}
