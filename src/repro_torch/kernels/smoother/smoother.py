"""The block smoothers' local updates on rank-stacked operands: the wrappers
of the hand-written CUDA kernels ``csrc/block_diag_apply.cu`` and
``csrc/tri_solve.cu``.

They replace no Pallas kernel: the reference applies each block smoother as
a dense per-rank factor, ``x + w · (minv @ r)`` with ``minv`` ``[D, m, m]``
(``repro/amg/dist_solve.py``, ``DistHierarchy._relax``), which these
compute from sparse factors:

* :func:`block_diag_apply` — block-Jacobi, ``x + w · Binv r`` with
  ``Binv`` ``[D, nb, bs, bs]``;
* :func:`tri_solve` — hybrid Gauss-Seidel's half-sweeps, ``x + w · T⁻¹ r``
  with ``T`` the lower (forward) or upper (backward) triangle of each rank's
  local square block, its strict part in ELL (``cols``/``vals``
  ``[D, m, K]``) and its diagonal apart (``diag`` ``[D, m]``).

``r`` and ``x`` are ``[D, m]`` or ``[D, m, k]``, in float32, float64 or
bfloat16 (the sparse kernels' rule: bfloat16 loads, float32 products and
sums, one rounding at the store; ``tri_solve`` keeps its solution ``T⁻¹ r``
in float32 between level sets).  A wrapper takes the plain
version (:mod:`.ref`) only for tensors that lie on the CPU; for CUDA tensors
it launches its kernel on the current stream or raises.
``<wrapper>.launches`` counts the launches the device ran, replays of a
captured CUDA graph included (:mod:`..launches`).  A ``tri_solve`` launch is
one kernel on its block route (each rank's solution in the shared memory of
one thread block) and on its staged route (the same, bfloat16 at k = 1,
every row's data streamed ahead from a :class:`TriSlab`), and a memset of
its scratch and one kernel on its L2 route (:func:`tri_plan` says which).
"""
from __future__ import annotations

import ctypes

import torch

from ..build import entry, kernel
from ..launches import note
from ..spmv.spmv import DTYPE_CODES, raise_on_error
from .ref import block_diag_apply_ref, level_schedule, tri_solve_ref


def _on_card(name: str, tensors: dict[str, torch.Tensor],
             r: torch.Tensor, x: torch.Tensor) -> bool:
    """Validate the operands shared by both kernels; True when they lie on
    a CUDA device (the kernel runs), False on the CPU (the plain version)."""
    dt = r.dtype
    if dt not in DTYPE_CODES:
        raise TypeError(f"{name}: float32, float64 or bfloat16 operands, "
                        f"got {dt}")
    for what, t in tensors.items():
        if t.dtype != (torch.int32 if what == "cols" else dt):
            raise TypeError(f"{name}: {what} is {t.dtype}, the source {dt}")
    if x.dtype != dt or x.shape != r.shape or r.ndim not in (2, 3):
        raise ValueError(f"{name}: r {r.dtype}{tuple(r.shape)} and x "
                         f"{x.dtype}{tuple(x.shape)} must be one [D, m(, k)]")
    dev = r.device
    if any(t.device != dev for t in (x, *tensors.values())):
        raise ValueError(f"{name}: operands lie on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in (r, x, *tensors.values())):
        raise ValueError(f"{name}: CUDA operands must be contiguous")
    return True


def block_diag_apply(binv: torch.Tensor, r: torch.Tensor, x: torch.Tensor,
                     w: float = 1.0) -> torch.Tensor:
    """``x + w · Binv r``: ``Binv`` ``[D, nb, bs, bs]``, ``nb =
    ceil(m / bs)``, the block grid restarting at each rank's first row."""
    on_card = _on_card("block_diag_apply", {"binv": binv}, r, x)
    D, m = r.shape[:2]
    if binv.ndim != 4 or binv.shape[0] != D or binv.shape[2] != binv.shape[3]:
        raise ValueError(f"block_diag_apply: Binv {tuple(binv.shape)} is no "
                         f"[D={D}, nb, bs, bs]")
    nb, bs = binv.shape[1], binv.shape[2]
    if bs == 0 or nb != -(-m // bs):
        raise ValueError(f"block_diag_apply: {nb} blocks of {bs} for {m} rows")
    if not on_card:
        return block_diag_apply_ref(binv, r, x, w)
    k = r.shape[2] if r.ndim == 3 else 1
    y = torch.empty_like(x)
    if D * m * k == 0:
        return y
    rc = kernel("block_diag_apply")(
        binv.data_ptr(), r.data_ptr(), x.data_ptr(), y.data_ptr(), D, m, nb,
        bs, k, float(w), DTYPE_CODES[r.dtype],
        torch.cuda.current_stream(r.device).cuda_stream)
    raise_on_error("block_diag_apply", rc)
    note(block_diag_apply)
    return y


# the three routes of the tri_solve kernel (csrc/tri_solve.cu) and their
# codes at its C entry point
TRI_ROUTES = ("block", "l2", "staged")
TRI_ROUTE_CODES = {"l2": 0, "block": 1, "staged": 2}
# the staged route's constants (csrc/tri_solve.cu: STAGED_*; a CPU test reads
# them there): rows a stage of the slab, and the ring's stages at least (a
# pass of one row a consumer thread spans that many) and at most
STAGED_ROWS = 128
STAGED_MIN_STAGES = 3
STAGED_MAX_STAGES = 8
# The rule's widest level sets for the block route at k = 1: the most rows
# a level set may hold on average, m / nlev, by bytes a value.  Measured on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6): on the 27-point
# stencil's lower triangle on n^3 boxes, 8 ranks (scripts/tune_kernel.py
# --kernel tri_solve --size 0 --cube N), the block route won up to 43.5
# rows a set in f64 and lost from 48.6; in f32 it won up to 29.8 and lost
# from 34.1, but lost at level 1 of laplace_3d(64) on 2 x 4 (28.3 rows a
# set, chip_smoke.py) and won at 25.8.  bfloat16 operands that do not take
# the staged route keep a float32 z and take f32's width.
BLOCK_MAX_WIDTH = {4: 26, 8: 44}
# The staged route's widest level sets (bfloat16, k = 1): the most rows a
# level set may hold on average, the widest it was measured faster at.  On
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6) it ran faster than
# the block and L2 routes at every non-coarsest level of laplace_3d(64) on
# 2 x 4, both triangles (1.4 to 150 rows a set), on a chain, on the
# 27-point stencil's n^3 boxes (10 to 200 rows a set) and on 32,768 rows a
# rank in sets of 150 to 4,096 rows of 13 slots and of 150 and 600 rows of
# 40 (scripts/tune_kernel.py --kernel tri_solve --dtype bfloat16 --cube N
# --wide W[:K]): one SM streams a rank's slab in about 0.087 ms there,
# while the L2 route still took 0.116 ms at 8 sets of 4,096 rows.
STAGED_MAX_WIDTH = 4096
_SMEM: dict[int, int] = {}


def tri_smem(device) -> int:
    """The opt-in shared memory a block may have on ``device`` (bytes),
    asked once a device: the block route's limit on a rank's solution."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    got = _SMEM.get(index)
    if got is None:
        out = ctypes.c_int(0)
        fn = entry("tri_solve", "tri_solve_smem", [ctypes.c_void_p])
        with torch.cuda.device(index):
            raise_on_error("tri_solve_smem", fn(ctypes.addressof(out)))
        got = _SMEM[index] = out.value
    return got


def z_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type ``tri_solve`` keeps its solution ``z = T⁻¹ r`` in, between
    level sets: float32 for bfloat16 operands, the operands' own type
    otherwise."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def staged_slots(K: int) -> int:
    """The slots a row takes in a :class:`TriSlab` for rows of ``K``
    slots: K up to 32 (the kernel's unrolled counts), past 32 K rounded up
    to 32."""
    return K if K <= 32 else -(-K // 32) * 32


def staged_stage_bytes(K: int) -> int:
    """The bytes of one stage of a :class:`TriSlab` for rows of ``K``
    slots: STAGED_ROWS 32-bit row headers, then ``staged_slots(K)`` ×
    STAGED_ROWS 32-bit slot words; a multiple of 16, as a bulk copy
    takes."""
    return 4 * STAGED_ROWS * (1 + staged_slots(K))


def staged_smem(m: int, nlev: int, K: int) -> int:
    """The least shared memory a block of the staged route needs: the
    rank's z (float32 ``[m + 1]``, z[m] = 0 for the padding slots) and its
    ``nlev + 1`` level-set starts, each rounded up to 16 bytes,
    STAGED_MIN_STAGES stages and the ring's barriers (16 bytes a stage,
    reserved for STAGED_MAX_STAGES)."""
    def round16(n):
        return -(-n // 16) * 16
    return (round16(4 * (m + 1)) + round16(4 * (nlev + 1))
            + STAGED_MIN_STAGES * staged_stage_bytes(K) + 16 * STAGED_MAX_STAGES)


def tri_routes(m: int, nlev: int, k: int, dtype: torch.dtype, smem: int, *,
               K: int = 0) -> list[str]:
    """The routes that can take a launch (:func:`tri_plan`'s arguments):
    the L2 route always, the block route where a rank's z fits a block, the
    staged route for bfloat16 operands at k = 1 where z, the starts and its
    smallest ring fit one (and rows and columns fit 16 bits)."""
    out = ["l2"]
    if m * k * z_dtype(dtype).itemsize <= smem:
        out.append("block")
    if (dtype == torch.bfloat16 and k == 1 and m < 1 << 16
            and staged_smem(m, nlev, K) <= smem):
        out.append("staged")
    return [r for r in TRI_ROUTES if r in out]


def tri_plan(m: int, nlev: int, k: int, dtype: torch.dtype, smem: int,
             route: str | None = None, *, K: int = 0) -> str:
    """The route of a ``tri_solve`` launch for ranks of ``m`` rows in
    ``nlev`` level sets and ``k`` right-hand sides of type ``dtype``, rows
    of ``K`` slots (the staged route's ring), decided before the launch:
    ``"block"``, ``"l2"`` or ``"staged"``.  Its solution ``z`` takes
    ``z_dtype(dtype)``'s bytes an element (4 for bfloat16 operands).

    The rule: the block route (one thread block a rank, its solution in
    shared memory) where the rank's solution fits the block, m·k·itemsize
    ≤ ``smem``, and, at k = 1, its level sets hold at most
    ``BLOCK_MAX_WIDTH[itemsize]`` rows on average (m / nlev ≤ that); the L2
    route elsewhere.  A block has one SM: it solves a narrow set in one
    pass and meets at a barrier cheaper than a wait through the L2, a wide
    set in many passes.  At k > 1 the block route won at every level of
    laplace_3d(64) on 2 x 4 that it holds, but on the 27-point stencil's
    cubes it lost up to 34.1 rows a set (and won from 38.6 in f32;
    PERF.md): the rule follows the solve's levels there.
    bfloat16 operands at k = 1 take the staged route where it can
    (:func:`tri_routes`) and their level sets hold at most
    ``STAGED_MAX_WIDTH`` rows on average.
    ``route`` forces one, for tests and measurement: ``"l2"``, ``"block"``
    (raises where the rank does not fit the block) or ``"staged"`` (raises
    where the route cannot take the case)."""
    itemsize = z_dtype(dtype).itemsize
    fits = m * k * itemsize <= smem
    can = tri_routes(m, nlev, k, dtype, smem, K=K)
    if route is None:
        if "staged" in can and m <= STAGED_MAX_WIDTH * max(nlev, 1):
            return "staged"
        wide = k == 1 and m > BLOCK_MAX_WIDTH[itemsize] * max(nlev, 1)
        return "block" if fits and not wide else "l2"
    if route == "l2":
        return route
    if route == "block":
        if not fits:
            raise ValueError(f"tri_solve: {m} rows of {k} x {itemsize} bytes "
                             f"do not fit a block's {smem} bytes")
        return route
    if route == "staged":
        if "staged" not in can:
            raise ValueError(
                f"tri_solve: the staged route takes bfloat16 at k = 1 where "
                f"z, the starts and {STAGED_MIN_STAGES} stages fit a block's "
                f"{smem} bytes; got {dtype}, k = {k}, {m} rows in {nlev} "
                f"level sets of {K} slots ({staged_smem(m, nlev, K)} bytes)")
        return route
    raise ValueError(f"tri_solve: route {route!r}, not one of {TRI_ROUTES}")


def staged_slab(cols: torch.Tensor, vals: torch.Tensor, diag: torch.Tensor,
                order: torch.Tensor) -> torch.Tensor:
    """The staged route's slab: uint8 ``[D, nst, staged_stage_bytes(K)]``,
    ``nst = ceil(m / R)``, R = STAGED_ROWS; stage q of rank d holds the
    rank's rows at positions q·R … q·R + R − 1 of ``order`` as 32-bit
    words, R row headers (row index | diagonal's bfloat16 bits << 16) and
    then KP = ``staged_slots(K)`` × R slot words, slot-major (column |
    value's bfloat16 bits << 16; padding slots column m, value 0).
    Positions past m hold zero words.  A level-ordered gather on the
    factor's device; raises unless m < 65536 (16-bit rows and columns)."""
    D, m, K = cols.shape
    if m >= 1 << 16:
        raise ValueError(f"tri_solve: the staged route's slab holds 16-bit "
                         f"rows and columns; got {m} rows a rank")
    R, KP = STAGED_ROWS, staged_slots(K)
    nst = -(-m // R)
    o = order.long()
    dev = cols.device

    def u16(t):                      # values 0 .. 65535 as int16 bits
        t = t.to(torch.int32)
        return torch.where(t >= 1 << 15, t - (1 << 16), t).to(torch.int16)

    def words(lo, hi):               # int16 halves -> int32 words
        return torch.stack([lo, hi], dim=-1).view(torch.int32)[..., 0]

    head = torch.zeros((D, nst * R), dtype=torch.int32, device=dev)
    head[:, :m] = words(u16(order), diag.to(torch.bfloat16).gather(1, o)
                        .view(torch.int16))
    slot = torch.zeros((D, nst * R, KP), dtype=torch.int32, device=dev)
    pad = torch.full((D, m, KP), m, dtype=torch.int32, device=dev)
    val = torch.zeros((D, m, KP), dtype=torch.bfloat16, device=dev)
    if K:
        ok = o[..., None].expand(D, m, K)
        c = cols.gather(1, ok)
        pad[..., :K] = torch.where(c >= 0, c, m)
        val[..., :K] = torch.where(c >= 0, vals.to(torch.bfloat16).gather(1, ok), 0)
    slot[:, :m] = words(u16(pad), val.view(torch.int16))
    slot = slot.reshape(D, nst, R, KP).transpose(2, 3).reshape(D, nst, KP * R)
    return torch.cat([head.reshape(D, nst, R), slot], dim=2).view(torch.uint8)


class TriSlab:
    """A triangle's slab (:func:`staged_slab`) for one row order, with the
    tensors it was built from: a launch takes it only for those tensors
    (the same objects) holding the values it was built from (their version
    counters unchanged); :meth:`fill` rewrites it in place from their
    current values, so captured graphs read the new ones."""

    def __init__(self, cols, vals, diag, order):
        self.source = (cols, vals, diag, order)
        self.data = staged_slab(cols, vals, diag, order)
        self._versions = self._now()

    def _now(self) -> tuple[int, ...]:
        return tuple(t._version for t in self.source)

    def serves(self, cols, vals, diag, order) -> bool:
        return (all(a is b for a, b in zip(self.source, (cols, vals, diag, order)))
                and self._now() == self._versions)

    def fill(self) -> None:
        self.data.copy_(staged_slab(*self.source))
        self._versions = self._now()


def _check_index(name: str, t, shape: tuple, dev) -> None:
    """Raise unless ``t`` is a contiguous int32 tensor of ``shape`` (None:
    any length but 0) on ``dev``."""
    if (t is None or t.dtype != torch.int32 or t.ndim != len(shape)
            or any(n is not None and n != got for n, got in zip(shape, t.shape))
            or t.shape[-1] == 0 or t.device != dev or not t.is_contiguous()):
        raise ValueError(f"tri_solve: the row {name} must be int32 "
                         f"{list(shape)} on {dev}")


def tri_solve(cols: torch.Tensor, vals: torch.Tensor, diag: torch.Tensor,
              r: torch.Tensor, x: torch.Tensor, w: float = 1.0, *,
              upper: bool, order=None,
              schedule: list[torch.Tensor] | None = None,
              route: str | None = None,
              slab: TriSlab | None = None) -> torch.Tensor:
    """``x + w · T⁻¹ r`` with ``T`` the strict triangle ``cols``/``vals``
    ``[D, m, K]`` (-1 padding; columns below the row for the lower
    triangle, above it for ``upper``) plus ``diag`` ``[D, m]``.

    On the card ``order`` is the kernel's row order, the int32 pair
    ``(order [D, m], starts [D, nlev + 1])`` of :func:`.ref.rank_level_order`
    and :func:`.ref.rank_level_starts` (``TriFactor.order``, ``.starts``; the
    rows of a level set may come in any order), and the launch takes the
    route :func:`tri_plan` gives (``route`` forces one, for tests).  The
    staged route reads ``slab`` where it serves these tensors and this
    order (:meth:`TriSlab.serves`; ``TriFactor.slab``), else builds one for
    the order given (refused under graph capture).  The plain version
    solves ``schedule`` (:func:`.ref.level_schedule`, computed from
    ``cols`` where it is not given); it ignores ``order``, ``route`` and
    ``slab``."""
    on_card = _on_card("tri_solve", {"cols": cols, "vals": vals, "diag": diag},
                       r, x)
    D, m = r.shape[:2]
    if (cols.ndim != 3 or tuple(cols.shape[:2]) != (D, m)
            or vals.shape != cols.shape or tuple(diag.shape) != (D, m)):
        raise ValueError(f"tri_solve: cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}, diag {tuple(diag.shape)} "
                         f"against r {tuple(r.shape)}")
    if not on_card:
        if schedule is None:
            schedule = level_schedule(cols.numpy(), upper)
        return tri_solve_ref(cols, vals, diag, r, x, w, schedule)
    K = cols.shape[2]
    k = r.shape[2] if r.ndim == 3 else 1
    y = torch.empty_like(x)
    if D * m * k == 0:
        return y
    if D * m >= 2 ** 31:
        raise ValueError(f"tri_solve: {D * m} rows, the kernel takes < 2^31")
    if not isinstance(order, tuple) or len(order) != 2:
        raise ValueError("tri_solve: the kernel needs order=(order [D, m], "
                         "starts [D, nlev + 1]), each rank's rows by level "
                         f"set; got {type(order).__name__}")
    o, starts = order
    _check_index("order", o, (D, m), r.device)
    _check_index("starts", starts, (D, None), r.device)
    nlev = starts.shape[1] - 1
    zt = z_dtype(r.dtype)
    plan = tri_plan(m, nlev, k, r.dtype, tri_smem(r.device), route, K=K)
    z = None
    if plan == "l2":      # its solution in device memory, set empty by the launch
        z = torch.empty_like(r, dtype=zt)
    elif plan == "staged":
        if slab is None or not slab.serves(cols, vals, diag, o):
            if r.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("tri_solve: the staged route's slab for "
                                   "these values and this order is built "
                                   "before a capture (TriFactor.slab)")
            slab = TriSlab(cols, vals, diag, o)
        z = slab.data
    rc = kernel("tri_solve")(
        cols.data_ptr(), vals.data_ptr(), diag.data_ptr(), r.data_ptr(),
        x.data_ptr(), o.data_ptr(), starts.data_ptr(),
        None if z is None else z.data_ptr(), y.data_ptr(), D, m, K, k, nlev,
        float(w), DTYPE_CODES[r.dtype], TRI_ROUTE_CODES[plan],
        torch.cuda.current_stream(r.device).cuda_stream)
    raise_on_error("tri_solve", rc)
    note(tri_solve)
    return y


block_diag_apply.launches = 0
tri_solve.launches = 0
