# Verbatim copy of repro/amg/splitting.py (numpy only); only the imports may differ.
"""CF splitting and aggregation (Algorithm 1, ``splitting``).

* :func:`pmis` — PMIS splitting [De Sterck, Yang, Heys 2005]; with
  ``aggressive=True`` it runs on the distance-2 strength graph, giving the
  HMIS-style aggressive coarsening the paper uses for its RS hierarchies.
* :func:`mis2_aggregation` — aggregates from a distance-2 maximal
  independent set (the paper's SA configuration).
"""
from __future__ import annotations

import numpy as np

from .csr import CSR

UNASSIGNED, FPOINT, CPOINT = 0, -1, 1


def _sym_graph(S: CSR) -> CSR:
    """S ∪ Sᵀ with unit weights."""
    return _drop_diag(S.add(S.T))


def _drop_diag(G: CSR) -> CSR:
    r = G.rows_expanded()
    keep = r != G.indices
    indptr = np.zeros(G.nrows + 1, dtype=np.int64)
    np.cumsum(np.bincount(r[keep], minlength=G.nrows), out=indptr[1:])
    return CSR(G.shape, indptr, G.indices[keep], np.ones(int(keep.sum())))


def _row_max(G: CSR, w: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Per-row max of w over neighbor columns where mask[col] (else -inf)."""
    vals = np.where(mask[G.indices], w[G.indices], -np.inf)
    out = np.full(G.nrows, -np.inf)
    np.maximum.at(out, G.rows_expanded(), vals)
    return out


def pmis(S: CSR, seed: int = 42, aggressive: bool = False) -> np.ndarray:
    """Return status array: CPOINT / FPOINT per node."""
    G = _sym_graph(S)
    if aggressive:
        G = _sym_graph(G.spgemm(G))  # distance-2 coupling (self-loops dropped)
    n = G.nrows
    rng = np.random.default_rng(seed)
    # weight: number of strong transpose connections + tiebreak random
    w = np.diff(S.T.indptr).astype(np.float64) + rng.random(n)
    status = np.full(n, UNASSIGNED, dtype=np.int64)
    # nodes with no strong connections become F (no interpolation needed)
    isolated = np.diff(G.indptr) == 0
    status[isolated] = FPOINT
    while (status == UNASSIGNED).any():
        unass = status == UNASSIGNED
        nb_max = _row_max(G, w, unass)
        new_c = unass & (w > nb_max)
        if not new_c.any():  # numeric tie safety
            idx = np.flatnonzero(unass)
            new_c = np.zeros(n, dtype=bool)
            new_c[idx[np.argmax(w[idx])]] = True
        status[new_c] = CPOINT
        # unassigned strongly influenced by a new C point -> F
        touched = np.zeros(n, dtype=bool)
        r = G.rows_expanded()
        touched[G.indices[new_c[r]]] = True      # neighbors of new C points
        status[(status == UNASSIGNED) & touched] = FPOINT
    return status


def mis2_aggregation(S: CSR, seed: int = 42) -> np.ndarray:
    """Aggregate nodes around a distance-2 MIS of the strength graph.

    Returns ``agg`` with agg[i] = aggregate id (0..n_agg-1).
    """
    G = _sym_graph(S)
    n = G.nrows
    G2 = _sym_graph(G.spgemm(G))
    rng = np.random.default_rng(seed)
    w = np.diff(G.indptr).astype(np.float64) + rng.random(n)
    in_mis = np.zeros(n, dtype=bool)
    killed = np.zeros(n, dtype=bool)
    while (~in_mis & ~killed).any():
        active = ~in_mis & ~killed
        nb_max = _row_max(G2, w, active)
        new = active & (w > nb_max)
        if not new.any():
            idx = np.flatnonzero(active)
            new = np.zeros(n, dtype=bool)
            new[idx[np.argmax(w[idx])]] = True
        in_mis |= new
        r = G2.rows_expanded()
        nb_of_new = np.zeros(n, dtype=bool)
        nb_of_new[G2.indices[new[r]]] = True
        killed |= nb_of_new & ~in_mis
    roots = np.flatnonzero(in_mis)
    agg = np.full(n, -1, dtype=np.int64)
    agg[roots] = np.arange(roots.size)
    # pass 1: unaggregated direct strong neighbors of roots
    r = G.rows_expanded()
    root_rows = in_mis[r]
    cand_nodes = G.indices[root_rows]
    cand_aggs = agg[r[root_rows]]
    free = agg[cand_nodes] == -1
    # first-come assignment
    agg[cand_nodes[free]] = cand_aggs[free]
    # pass 2: join any aggregated strong neighbor (repeat to closure)
    for _ in range(3):
        un = agg == -1
        if not un.any():
            break
        nbr_agg = np.full(n, -1, dtype=np.int64)
        has = agg[G.indices] >= 0
        np.maximum.at(nbr_agg, r[has], agg[G.indices[has]])
        adopt = un & (nbr_agg >= 0)
        agg[adopt] = nbr_agg[adopt]
    # pass 3: leftovers become singletons
    left = np.flatnonzero(agg == -1)
    if left.size:
        agg[left] = int(agg.max(initial=-1)) + 1 + np.arange(left.size)
    # compact ids
    _, agg = np.unique(agg, return_inverse=True)
    return agg.astype(np.int64)
