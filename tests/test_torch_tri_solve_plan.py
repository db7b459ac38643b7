"""The host side of the ``tri_solve`` kernel, on the CPU: its row order
(``ref.rank_level_order``: each rank's rows by level set) and where each
rank's level sets begin (``ref.rank_level_starts``), the route rule
(``smoother.tri_plan``) at its thresholds and against the routes' times
measured on the card, the staged route's rule (bfloat16 at k = 1 where z,
the starts and its smallest ring fit a block, its constants read from the
kernel's source), a replay of the L2 route's static schedule (groups
taking positions by a fixed stride over every rank, each waiting on its
row's dependencies) that must finish with every row once, and the plain
version, which the route and order keywords leave as it was."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.smoother import ref as sref  # noqa: E402
from repro_torch.kernels.smoother import smoother as sm  # noqa: E402
from repro_torch.kernels.smoother.ops import TriFactor  # noqa: E402

H100_SMEM = 232_448          # opt-in shared memory a block on an H100


def _triangle(rng, D, m, K, upper):
    """Random strict triangles ``cols`` ``[D, m, K]`` (-1 padding)."""
    cols = np.full((D, m, K), -1, dtype=np.int32)
    for d in range(D):
        for i in range(m):
            cand = np.arange(i + 1, m) if upper else np.arange(i)
            n = min(len(cand), int(rng.integers(0, K + 1)))
            c = np.sort(rng.choice(cand, size=n, replace=False))
            cols[d, i, :c.size] = c
    return cols


def _stencil(n, upper):
    """The strict lower (or upper) triangle of the 27-point stencil on an
    n³ grid in natural order: 13 entries a row, DAG depth 7(n-1) + 1."""
    idx = np.arange(n ** 3).reshape(n, n, n)           # [z, y, x]
    offs = [o for o in np.ndindex(3, 3, 3)
            if ((o > (1, 1, 1)) if upper else (o < (1, 1, 1)))]
    cols = np.full((n ** 3, len(offs)), -1, dtype=np.int32)
    zz, yy, xx = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    for e, (dz, dy, dx) in enumerate(offs):
        z, y, x = zz + dz - 1, yy + dy - 1, xx + dx - 1
        ok = (z >= 0) & (z < n) & (y >= 0) & (y < n) & (x >= 0) & (x < n)
        cols[idx[ok], e] = idx[z[ok], y[ok], x[ok]]
    return cols[None]


def _replay(cols, order, groups):
    """The L2 route's static schedule, step by step: ``groups`` groups take
    global positions p, p + groups, ... in turn, position p being rank
    p % D's row ``order[p % D, p // D]``; a step finishes the current row
    of every group whose dependencies are done.  Returns the steps taken,
    or None on a deadlock (no group can move while rows are left)."""
    D, m, _ = cols.shape
    done = np.zeros((D, m), dtype=bool)
    queues = [[(p % D, order[p % D, p // D]) for p in range(q, D * m, groups)]
              for q in range(groups)]
    heads = [0] * groups
    steps = 0
    while not done.all():
        ready = []
        for n, queue in enumerate(queues):
            if heads[n] < len(queue):
                d, i = queue[heads[n]]
                c = cols[d, i][cols[d, i] >= 0]
                if done[d, c].all():
                    ready.append((n, d, i))
        if not ready:
            return None
        for n, d, i in ready:
            assert not done[d, i]
            done[d, i] = True
            heads[n] += 1
        steps += 1
    return steps


@pytest.mark.parametrize("upper", [False, True], ids=["lower", "upper"])
@pytest.mark.parametrize("m", [1, 7, 40, 119, 120, 500])
def test_block_level_order_lists_each_block_by_level_set(upper, m):
    """Every rank's order is a permutation of its rows, by level set and
    then by row; every dependency sits in a lower level set, so every row
    comes after each row it depends on."""
    rng = np.random.default_rng(m)
    D, K = 3, 9
    cols = _triangle(rng, D, m, K, upper)
    lev = sref.dag_levels(cols, upper)
    order = sref.rank_level_order(lev)
    assert order.dtype == np.int32 and order.shape == (D, m)
    for d in range(D):
        assert np.array_equal(np.sort(order[d]), np.arange(m))
        key = lev[d, order[d]].astype(np.int64) * m + order[d]
        assert np.all(np.diff(key) > 0)
        pos = np.empty(m, dtype=np.int64)
        pos[order[d]] = np.arange(m)
        for i in range(m):
            c = cols[d, i][cols[d, i] >= 0]
            assert np.all(lev[d, c] < lev[d, i])
            assert np.all(pos[c] < pos[i])


@pytest.mark.parametrize("upper", [False, True], ids=["lower", "upper"])
@pytest.mark.parametrize("m,groups", [(120, 1), (120, 8), (30, 4), (17, 3),
                                      (1, 2)])
def test_static_schedule_finishes_every_row(upper, m, groups):
    """Replayed step by step, the L2 route's static schedule over the level
    order finishes every row once, never stalling, with any number of
    groups; so does the natural order; the level-set count bounds the steps
    from below."""
    rng = np.random.default_rng(groups * 1000 + m)
    D, K = 2, 6
    cols = _triangle(rng, D, m, K, upper)
    lev = sref.dag_levels(cols, upper)
    steps = _replay(cols, sref.rank_level_order(lev), groups)
    assert steps is not None and steps >= lev.max() + 1
    natural = np.tile(np.arange(m)[::-1] if upper else np.arange(m),
                      (D, 1)).astype(np.int32)
    assert _replay(cols, natural, groups) is not None


def test_static_schedule_at_the_stencil_depth():
    """The 27-point stencil's triangles (13 entries a row) on 8³: depth 50
    (7·(n-1) + 1), and the replay takes exactly that many steps when every
    position has a group of its own."""
    for upper in (False, True):
        cols = _stencil(8, upper)
        assert cols.shape == (1, 512, 13)
        lev = sref.dag_levels(cols, upper)
        assert lev.max() + 1 == 50
        assert _replay(cols, sref.rank_level_order(lev), 512) == 50


@pytest.mark.parametrize("k,itemsize", [(1, 8), (1, 4), (8, 8), (8, 4),
                                        (3, 8), (33, 4)])
def test_tri_plan_at_its_thresholds(k, itemsize):
    """The rule: the block route where the rank fits a block's shared
    memory and, at k = 1, its level sets hold at most BLOCK_MAX_WIDTH rows
    on average; the L2 route one row past either edge (at k > 1 the width
    does not count); a forced block raises past the shared memory, a forced
    L2 is taken anywhere."""
    per = H100_SMEM // (k * itemsize)         # rows one block holds
    width = sm.BLOCK_MAX_WIDTH[itemsize]
    dtype = {4: torch.float32, 8: torch.float64}[itemsize]

    def plan(m, nlev, k, itemsize, smem, route=None):
        return sm.tri_plan(m, nlev, k, dtype, smem, route)
    assert plan(1, 1, k, itemsize, H100_SMEM) == "block"
    # the width's edge, 3 level sets
    assert plan(3 * width, 3, k, itemsize, H100_SMEM) == "block"
    assert plan(3 * width + 1, 3, k, itemsize, H100_SMEM) == (
        "l2" if k == 1 else "block")
    # the shared memory's edge, one level set and a chain
    for nlev in (1, per):
        assert plan(per, nlev, k, itemsize, H100_SMEM) == (
            "block" if k > 1 or nlev == per else "l2")
        assert plan(per + 1, nlev, k, itemsize, H100_SMEM) == "l2"
    assert plan(per, per, k, itemsize, H100_SMEM, "block") == "block"
    with pytest.raises(ValueError):
        plan(per + 1, per + 1, k, itemsize, H100_SMEM, "block")
    # forced: the block past the width, L2 anywhere
    assert plan(3 * width + 1, 3, k, itemsize, H100_SMEM, "block") == "block"
    assert plan(1, 1, k, itemsize, H100_SMEM, "l2") == "l2"
    for bad in ("cluster", 4, "tickets"):
        with pytest.raises(ValueError):
            plan(37, 5, k, itemsize, H100_SMEM, bad)


# laplace_3d(64) on 2 x 4 ranks: each non-coarsest level's rows a rank and
# the lower triangle's level sets
MAIN_PATH = {0: (32_768, 218), 1: (2_689, 95), 2: (375, 42), 3: (57, 18),
             4: (13, 9)}


def test_tri_plan_of_the_main_path():
    """laplace_3d(64) on 2 x 4 ranks: level 0's 32,768 rows a rank (about
    150 a level set) take the L2 route at k = 1 and 8 in f32 and f64 (in
    f64 and at k = 8 no block holds them; a forced block raises); levels
    2-4 (9 rows a level set and fewer) one block a rank; level 1 (28 rows
    a set) by the width of its type and k."""
    for k in (1, 8):
        for s, dtype in ((4, torch.float32), (8, torch.float64)):
            assert sm.tri_plan(*MAIN_PATH[0], k, dtype, H100_SMEM) == "l2"
            for level in (2, 3, 4):
                assert sm.tri_plan(*MAIN_PATH[level], k, dtype, H100_SMEM) == "block"
            if (k, s) != (1, 4):
                with pytest.raises(ValueError):
                    sm.tri_plan(*MAIN_PATH[0], k, dtype, H100_SMEM, "block")
    assert sm.tri_plan(*MAIN_PATH[0], 1, torch.float32, H100_SMEM, "block") == "block"


@pytest.mark.parametrize("dtype,code,zbytes", [
    (torch.float32, 0, 4), (torch.float64, 1, 8), (torch.bfloat16, 2, 4)])
def test_tri_plan_reads_the_bytes_of_z(monkeypatch, dtype, code, zbytes):
    """The launch plans its route on the bytes of z, the solution it keeps
    between level sets: float32's 4 for bfloat16 operands (no rule keyed
    by 2 bytes, and the block's shared memory counted as the block route
    uses it), and on the operands' type and slots (the staged route's
    needs: bfloat16 at k = 1 takes it at level 0); it passes the type's
    dtype code and the route's code and, on the L2 route, a scratch z of
    that type, on the staged route the slab (the kernel itself stubbed: no
    card here)."""
    planned, launched, scratch = [], [], []
    monkeypatch.setattr(sm, "_on_card", lambda *a: True)
    monkeypatch.setattr(sm, "tri_smem", lambda dev: H100_SMEM)
    monkeypatch.setattr(sm, "note", lambda fn: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    real_plan, real_empty = sm.tri_plan, torch.empty_like

    def plan(*args, **kw):
        planned.append((args, kw))
        return real_plan(*args, **kw)

    def empty_like(t, **kw):
        z = real_empty(t, **kw)
        scratch.append(z)
        return z

    monkeypatch.setattr(sm, "tri_plan", plan)
    monkeypatch.setattr(torch, "empty_like", empty_like)
    monkeypatch.setattr(sm, "kernel", lambda name: (
        lambda *args: launched.append(args) or 0))
    rng = np.random.default_rng(3)
    m, nlev = MAIN_PATH[0]
    for k, route in ((1, None), (8, None), (1, "block"), (1, "staged")):
        cols = torch.as_tensor(np.full((2, m, 1), -1, dtype=np.int32))
        vals = torch.zeros((2, m, 1), dtype=dtype)
        diag = torch.ones((2, m), dtype=dtype)
        shape = (2, m) + ((k,) if k > 1 else ())
        r = torch.as_tensor(rng.standard_normal(shape)).to(dtype)
        starts = torch.zeros((2, nlev + 1), dtype=torch.int32)
        order = (torch.zeros((2, m), dtype=torch.int32), starts)
        del scratch[:]
        if route == "block" and m * k * zbytes > H100_SMEM:
            with pytest.raises(ValueError, match="do not fit"):
                sm.tri_solve(cols, vals, diag, r, r, upper=False, order=order,
                             route=route)
            continue
        if route == "staged" and dtype != torch.bfloat16:
            with pytest.raises(ValueError, match="staged route"):
                sm.tri_solve(cols, vals, diag, r, r, upper=False, order=order,
                             route=route)
            continue
        sm.tri_solve(cols, vals, diag, r, r, upper=False, order=order,
                     route=route)
        want = route or ("staged" if dtype == torch.bfloat16 and k == 1
                         else "l2")
        assert planned[-1][0][:4] == (m, nlev, k, dtype)
        assert sm.z_dtype(dtype).itemsize == zbytes
        assert planned[-1][1] == {"K": 1}
        assert launched[-1][15:17] == (code, sm.TRI_ROUTE_CODES[want])
        # y, then (on the L2 route) the scratch z
        assert [z.dtype for z in scratch] == (
            [dtype, sm.z_dtype(dtype)] if want == "l2" else [dtype])
        if want == "staged":            # the slab in z's place
            assert launched[-1][7] not in (None, 0)
    assert sm.z_dtype(torch.bfloat16) == torch.float32


# The routes' times at each main-path level (lower triangle, ms): the block
# route, the L2 route (None where a rank does not fit a block).  chip_smoke.py
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6).
MEASURED = {
    ("float64", 1): [(None, 0.4237), (0.1586, 0.1659), (0.0488, 0.0752),
                     (0.0175, 0.0338), (0.0087, 0.0183)],
    ("float64", 8): [(None, 0.9049), (0.2402, 0.2872), (0.1103, 0.1539),
                     (0.0371, 0.0624), (0.0150, 0.0201)],
    ("float32", 1): [(0.8952, 0.2945), (0.1399, 0.1122), (0.0459, 0.0513),
                     (0.0164, 0.0238), (0.0083, 0.0137)],
    ("float32", 8): [(None, 0.8447), (0.1782, 0.2770), (0.0927, 0.1496),
                     (0.0309, 0.0609), (0.0129, 0.0197)],
}


@pytest.mark.parametrize("level", sorted(MAIN_PATH))
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tri_plan_takes_the_faster_measured_route(dtype, k, level):
    """At every main-path level, k and type the rule takes the route that
    ran faster on the card (the L2 route where a rank does not fit a
    block)."""
    block_ms, l2_ms = MEASURED[dtype, k][level]
    itemsize = 4 if dtype == "float32" else 8
    m, nlev = MAIN_PATH[level]
    assert (block_ms is None) == (m * k * itemsize > H100_SMEM)
    want = "l2" if block_ms is None or l2_ms < block_ms else "block"
    assert sm.tri_plan(m, nlev, k, getattr(torch, dtype), H100_SMEM) == want


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("route", [None, "block", "l2"])
def test_plain_version_is_unchanged(route, k):
    """On the CPU the wrapper is the plain level-scheduled solve, bit for
    bit, whatever route or order it is handed; a factor's apply through the
    wrapper equals its explicit plain apply."""
    rng = np.random.default_rng(5)
    D, m, K = 2, 50, 7
    for upper in (False, True):
        cols = _triangle(rng, D, m, K, upper)
        vals = rng.standard_normal((D, m, K)) * (cols >= 0) * 0.2
        diag = 1.0 + rng.random((D, m))
        shape = (D, m) + (() if k is None else (k,))
        r, x = (torch.as_tensor(rng.standard_normal(shape)) for _ in range(2))
        c, v, dg = (torch.as_tensor(a) for a in (cols, vals, diag))
        want = sref.tri_solve_ref(c, v, dg, r, x, 0.8,
                                  sref.level_schedule(cols, upper))
        for order in (None, "not an order"):
            got = sm.tri_solve(c, v, dg, r, x, 0.8, upper=upper, route=route,
                               order=order)
            assert torch.equal(got, want)
        f = TriFactor.place({"cols": cols, "vals": vals, "diag": diag,
                             "upper": upper}, "cpu", torch.float64)
        assert torch.equal(f.apply(r, x, 0.8), f.apply(r, x, 0.8, False))
        assert torch.equal(f.apply(r, x, 0.8), want)


def test_factor_builds_each_order_once():
    """``place`` builds the kernel's row order once per pattern:
    ``rank_level_order`` and ``rank_level_starts`` as int32 on the factor's
    device, counted in the factor's tensors."""
    rng = np.random.default_rng(9)
    cols = _triangle(rng, 2, 40, 5, False)
    f = TriFactor.place({"cols": cols, "vals": np.ones(cols.shape),
                         "diag": np.ones((2, 40)), "upper": False},
                        "cpu", torch.float32)
    assert f.order.dtype == f.starts.dtype == torch.int32
    assert tuple(f.order.shape) == (2, 40)
    assert tuple(f.starts.shape) == (2, f.depth() + 1)
    assert np.array_equal(f.order.numpy(), sref.rank_level_order(f.levels))
    assert np.array_equal(f.starts.numpy(), sref.rank_level_starts(f.levels))
    assert f.tensors() == (f.cols, f.vals, f.diag, f.order, f.starts)


@pytest.mark.parametrize("m", [1, 7, 40, 119, 120, 500])
def test_block_level_starts_bound_each_level_set(m):
    """``starts`` cuts each rank's ``rank_level_order`` into its level
    sets: every set L has exactly the rank's rows of level L, the sets tile
    the rank's rows, and a rank with fewer sets has empty ones at its
    end."""
    rng = np.random.default_rng(m + 1)
    D = 3
    cols = _triangle(rng, D, m, 9, False)
    cols[2, :, :] = -1                        # one rank of a single set
    lev = sref.dag_levels(cols, False)
    order = sref.rank_level_order(lev)
    starts = sref.rank_level_starts(lev)
    nlev = lev.max() + 1
    assert starts.dtype == np.int32 and starts.shape == (D, nlev + 1)
    for d in range(D):
        st = starts[d]
        assert st[0] == 0 and st[-1] == m
        assert np.all(np.diff(st) >= 0)
        for L in range(nlev):
            got = order[d, st[L]:st[L + 1]]
            assert np.all(lev[d, got] == L)
            assert len(got) == np.count_nonzero(lev[d] == L)
    assert np.all(starts[2, 1:] == m)


# ------------------------------------------------------------ the staged route
CU = (Path(sm.__file__).parent / "csrc" / "tri_solve.cu").read_text()


def _cu_int(name):
    """A ``constexpr int`` of the kernel's source."""
    m = re.search(rf"constexpr int {name} = (\d+);", CU)
    assert m, name
    return int(m.group(1))


def test_staged_constants_are_the_kernels():
    """The wrapper's staged-route constants are the kernel's (read from
    ``csrc/tri_solve.cu``), its stage bytes the kernel's formula, a pass
    of one row a consumer fits the smallest ring, and a stage is a multiple
    of 16 bytes (one bulk copy) for every K."""
    assert sm.STAGED_ROWS == _cu_int("STAGED_ROWS")
    assert sm.STAGED_MIN_STAGES == _cu_int("STAGED_MIN_STAGES")
    assert sm.STAGED_MAX_STAGES == _cu_int("STAGED_MAX_STAGES")
    assert "return 4 * STAGED_ROWS * (1 + staged_slots(K));" in CU
    assert "return K <= 32 ? K : (K + 31) / 32 * 32;" in CU
    assert [sm.staged_slots(K) for K in (0, 1, 4, 13, 32, 33, 70)] == [
        0, 1, 4, 13, 32, 64, 96]
    # an instance of the kernel for each slot count up to 32
    assert all(f"STAGED_CASE({K})" in CU for K in range(33))
    assert "constexpr int ROUTE_L2 = 0, ROUTE_BLOCK = 1, ROUTE_STAGED = 2;" in CU
    assert sm.TRI_ROUTE_CODES == {"l2": 0, "block": 1, "staged": 2}
    consumers = _cu_int("STAGED_CONSUMERS")
    assert sm.STAGED_MIN_STAGES >= consumers // sm.STAGED_ROWS + 1
    assert sm.STAGED_ROWS % 8 == 0
    for K in range(0, 80):
        assert sm.staged_stage_bytes(K) % 16 == 0


@pytest.mark.parametrize("K", [1, 13, 26, 40])
def test_tri_plan_staged_only_for_bf16_at_k1(K):
    """The staged route is planned for bfloat16 operands at k = 1 where it
    fits (at the main path's sizes, rows of up to 32 slots everywhere),
    never for float32 or float64 (whatever their bytes), never at k > 1,
    forced, it raises in each of those cases."""
    bf16 = torch.bfloat16
    for m, nlev in [(13, 9), (375, 42), (2_689, 95), (32_768, 218)]:
        fits = sm.staged_smem(m, nlev, K) <= H100_SMEM
        assert fits or (K > 32 and m == 32_768)
        assert (sm.tri_plan(m, nlev, 1, bf16, H100_SMEM, K=K)
                == "staged") == fits
        assert ("staged" in sm.tri_routes(m, nlev, 1, bf16, H100_SMEM,
                                          K=K)) == fits
        if not fits:
            continue
        for dtype in (torch.float32, torch.float64):
            assert sm.tri_plan(m, nlev, 1, dtype, H100_SMEM, K=K) != "staged"
            assert "staged" not in sm.tri_routes(m, nlev, 1, dtype, H100_SMEM, K=K)
            with pytest.raises(ValueError, match="staged route"):
                sm.tri_plan(m, nlev, 1, dtype, H100_SMEM, "staged", K=K)
        for k in (2, 8):
            assert sm.tri_plan(m, nlev, k, bf16, H100_SMEM, K=K) != "staged"
            assert "staged" not in sm.tri_routes(m, nlev, k, bf16, H100_SMEM,
                                                 K=K)
            with pytest.raises(ValueError, match="staged route"):
                sm.tri_plan(m, nlev, k, bf16, H100_SMEM, "staged", K=K)
        assert sm.tri_plan(m, nlev, 1, bf16, H100_SMEM, "staged",
                           K=K) == "staged"


@pytest.mark.parametrize("K", [0, 13, 40, 70])
def test_tri_plan_staged_at_its_shared_memory_edge(K):
    """z (4 bytes a row and a zero slot), the starts (4 a level set, each
    rounded to 16),
    STAGED_MIN_STAGES stages of K slots and 16 bytes a stage of barriers at
    STAGED_MAX_STAGES: the rank that just fits takes the staged route, one
    row more (a chain: one more level set too) does not, where a forced
    staged route raises and the rule falls back to the other routes."""
    fixed = sm.STAGED_MIN_STAGES * sm.staged_stage_bytes(K) + 16 * sm.STAGED_MAX_STAGES
    bf16 = torch.bfloat16
    if fixed + 32 > H100_SMEM:           # rows of 65+ slots: no ring fits
        assert "staged" not in sm.tri_routes(1, 1, 1, bf16, H100_SMEM, K=K)
        with pytest.raises(ValueError, match="staged route"):
            sm.tri_plan(1, 1, 1, bf16, H100_SMEM, "staged", K=K)
        return
    m = (H100_SMEM - fixed) // 8 // 4 * 4 - 1     # a chain: nlev = m
    assert sm.staged_smem(m, m, K) <= H100_SMEM < sm.staged_smem(m + 4, m + 4, K)
    while sm.staged_smem(m + 1, m + 1, K) <= H100_SMEM:
        m += 1
    assert sm.tri_plan(m, m, 1, bf16, H100_SMEM, K=K) == "staged"
    assert sm.tri_plan(m + 1, m + 1, 1, bf16, H100_SMEM,
                       K=K) == sm.tri_plan(m + 1, m + 1, 1, torch.float32, H100_SMEM)
    with pytest.raises(ValueError, match="staged route"):
        sm.tri_plan(m + 1, m + 1, 1, bf16, H100_SMEM, "staged", K=K)
    # few level sets leave room for more rows (forced past the rule's width)
    assert "staged" in sm.tri_routes(m + 1, 1, 1, bf16, H100_SMEM, K=K)
    assert sm.tri_plan(m + 1, 1, 1, bf16, H100_SMEM, "staged", K=K) == "staged"


def test_tri_plan_of_the_bf16_main_path():
    """laplace_3d(64) on 2 x 4 ranks in bfloat16: every non-coarsest level
    takes the staged route at k = 1 (level 0's z is 128 KiB, its slab's
    ring the rest), and the k = 8 chunk keeps the routes of float32."""
    bf16 = torch.bfloat16
    for level, (m, nlev) in MAIN_PATH.items():
        assert sm.tri_plan(m, nlev, 1, bf16, H100_SMEM, K=13) == "staged"
        assert sm.tri_plan(m, nlev, 8, bf16, H100_SMEM,
                           K=13) == sm.tri_plan(m, nlev, 8, torch.float32, H100_SMEM)


@pytest.mark.parametrize("nlev", [1, 4, 8])
def test_tri_plan_staged_up_to_its_width(nlev):
    """The rule takes the staged route up to STAGED_MAX_WIDTH rows a level
    set on average (the widest it measured faster at) and, one row past
    it, the route float32's rule gives; forced, the staged route is still
    taken there where it fits."""
    bf16, K = torch.bfloat16, 13
    m = sm.STAGED_MAX_WIDTH * nlev
    assert "staged" in sm.tri_routes(m + 1, nlev, 1, bf16, H100_SMEM, K=K)
    assert sm.tri_plan(m, nlev, 1, bf16, H100_SMEM, K=K) == "staged"
    assert sm.tri_plan(m + 1, nlev, 1, bf16, H100_SMEM, K=K) == sm.tri_plan(
        m + 1, nlev, 1, torch.float32, H100_SMEM) != "staged"
    assert sm.tri_plan(m + 1, nlev, 1, bf16, H100_SMEM, "staged", K=K) == "staged"


@pytest.mark.parametrize("m", [65_535, 65_536])
def test_staged_slab_refuses_rows_past_16_bits(m):
    """The slab holds 16-bit row and column ids: it is built for 65,535
    rows a rank and refused from 65,536 (where the route is never
    planned), never wrapped."""
    cols = torch.full((1, m, 0), -1, dtype=torch.int32)
    vals = torch.zeros((1, m, 0), dtype=torch.bfloat16)
    diag = torch.ones((1, m), dtype=torch.bfloat16)
    order = torch.arange(m, dtype=torch.int32)[None]
    assert "staged" not in sm.tri_routes(65_536, 1, 1, torch.bfloat16, 1 << 30)
    if m < 1 << 16:
        slab = sm.staged_slab(cols, vals, diag, order)
        assert tuple(slab.shape) == (1, -(-m // sm.STAGED_ROWS),
                                     sm.staged_stage_bytes(0))
        return
    with pytest.raises(ValueError, match="16-bit"):
        sm.staged_slab(cols, vals, diag, order)
