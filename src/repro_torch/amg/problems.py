# Verbatim copy of repro/amg/problems.py (numpy only); only the imports may differ.
"""Test problems mirroring the paper's systems (MFEM-built in the paper;
stencil-built stand-ins here, with matching character).

* :func:`laplace_3d`       — 27-point FEM-style 3D Laplacian (Example 2.1).
* :func:`grad_div_3d`      — 3-component coupled vector system with a mass
  term (the MFEM Grad-Div system's character: vector dofs, strong coupling,
  ~40 nnz/row).
* :func:`dpg_laplace_3d`   — very dense rows (~100+ nnz/row on modest n),
  matching the DPG system's extreme density (104.5M nnz on 131k rows).
* :func:`rotated_anisotropic_2d` — 9-point FD rotated anisotropic diffusion
  (the Fig. 21 system).
"""
from __future__ import annotations

import numpy as np

from .csr import CSR


def _grid_ids(*dims):
    grids = np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")
    return [g.ravel() for g in grids]


def stencil_grid(stencil: np.ndarray, dims: tuple[int, ...]) -> CSR:
    """Assemble a matrix from an arbitrary odd-shaped stencil on a regular
    grid with homogeneous Dirichlet truncation (PyAMG-style)."""
    stencil = np.asarray(stencil, dtype=np.float64)
    nd = stencil.ndim
    assert len(dims) == nd
    n = int(np.prod(dims))
    centers = [(s - 1) // 2 for s in stencil.shape]
    coords = _grid_ids(*dims)
    rows_all, cols_all, vals_all = [], [], []
    it = np.ndindex(*stencil.shape)
    strides = np.cumprod([1] + list(dims[::-1]))[::-1][1:]  # row-major strides
    for off in it:
        v = stencil[off]
        if v == 0.0:
            continue
        d = [o - c for o, c in zip(off, centers)]
        mask = np.ones(n, dtype=bool)
        col = np.zeros(n, dtype=np.int64)
        for axis in range(nd):
            ci = coords[axis] + d[axis]
            mask &= (ci >= 0) & (ci < dims[axis])
            col += np.where(mask, ci, 0) * strides[axis]
        rows = np.flatnonzero(mask)
        rows_all.append(rows)
        cols_all.append(col[rows])
        vals_all.append(np.full(rows.size, v))
    return CSR.from_coo(np.concatenate(rows_all), np.concatenate(cols_all),
                        np.concatenate(vals_all), (n, n))


def laplace_3d(nx: int, ny: int | None = None, nz: int | None = None) -> CSR:
    """27-point 3D Laplacian (trilinear FEM stencil)."""
    ny = ny or nx
    nz = nz or nx
    st = -np.ones((3, 3, 3))
    st[1, 1, 1] = 26.0
    return stencil_grid(st, (nx, ny, nz))


def laplace_3d_7pt(nx: int, ny: int | None = None, nz: int | None = None) -> CSR:
    ny = ny or nx
    nz = nz or nx
    st = np.zeros((3, 3, 3))
    st[1, 1, 1] = 6.0
    for d in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        st[d] = -1.0
    return stencil_grid(st, (nx, ny, nz))


def grad_div_3d(nx: int, alpha: float = 1.0, beta: float = 1.0) -> CSR:
    """-∇(α ∇·F) + βF character: 3 coupled components on a 3D grid.

    Each component carries a 27-pt operator plus a mass term; components are
    coupled through mixed-difference blocks (the grad-div cross terms).
    """
    n = nx ** 3
    K = laplace_3d(nx)
    # mass term on the diagonal
    comp = K.add(CSR.eye(n, value=beta * 8.0))
    # cross-component coupling: forward/backward difference pattern
    st = np.zeros((3, 3, 3))
    st[0, 1, 1], st[2, 1, 1] = -0.5 * alpha, 0.5 * alpha
    st[1, 0, 1], st[1, 2, 1] = -0.5 * alpha, 0.5 * alpha
    Cx = stencil_grid(st, (nx, nx, nx))
    rows, cols, vals = [], [], []

    def place(block: CSR, bi: int, bj: int):
        rows.append(block.rows_expanded() + bi * n)
        cols.append(block.indices + bj * n)
        vals.append(block.data)

    for c in range(3):
        place(comp, c, c)
    for (bi, bj) in ((0, 1), (1, 2), (0, 2)):
        place(Cx, bi, bj)
        place(Cx.T, bj, bi)
    return CSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals), (3 * n, 3 * n))


def dpg_laplace_3d(nx: int, bandwidth: int = 60, seed: int = 0) -> CSR:
    """DPG-character system: modest rows, very dense (~2·bandwidth nnz/row),
    SPD via diagonal dominance.  The paper's DPG system has ~800 nnz/row."""
    n = nx ** 3
    rng = np.random.default_rng(seed)
    base = laplace_3d_7pt(nx)
    rows, cols, vals = [base.rows_expanded()], [base.indices], [base.data]
    # add dense local coupling bands (graph distance in lexicographic order)
    r = np.arange(n, dtype=np.int64)
    for k in range(2, bandwidth, 3):
        mask = r + k < n
        rr = r[mask]
        cc = rr + k
        vv = -np.abs(rng.standard_normal(rr.size)) * (0.5 / k)
        rows += [rr, cc]
        cols += [cc, rr]
        vals += [vv, vv]
    A = CSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                     np.concatenate(vals), (n, n))
    # enforce diagonal dominance -> SPD, AMG-amenable
    d = A.diagonal()
    rowabs = np.zeros(n)
    np.add.at(rowabs, A.rows_expanded(), np.abs(A.data))
    rowabs -= np.abs(d)  # sum of |off-diagonals| per row
    D = CSR.from_diag(rowabs * 1.05 - d + 1.0)
    return A.add(D)


def rotated_anisotropic_2d(nx: int, eps: float = 0.001, theta: float = np.pi / 4) -> CSR:
    """FD discretization of rotated anisotropic diffusion (Fig. 21 system)."""
    c, s = np.cos(theta), np.sin(theta)
    cxx = c * c + eps * s * s
    cyy = s * s + eps * c * c
    cxy = 2 * (1 - eps) * c * s
    st = np.array([
        [-0.25 * cxy - 0.0, -cyy, 0.25 * cxy],
        [-cxx, 2 * cxx + 2 * cyy, -cxx],
        [0.25 * cxy, -cyy, -0.25 * cxy - 0.0],
    ])
    return stencil_grid(st, (nx, nx))


PROBLEMS = {
    "laplace3d": lambda n=24: laplace_3d(n),
    "laplace3d_7pt": lambda n=24: laplace_3d_7pt(n),
    "graddiv": lambda n=14: grad_div_3d(n),
    "dpg": lambda n=12: dpg_laplace_3d(n),
    "rot_aniso2d": lambda n=64: rotated_anisotropic_2d(n),
}
