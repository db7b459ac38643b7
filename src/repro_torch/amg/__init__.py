"""Algebraic multigrid on PyTorch (port of :mod:`repro.amg`).

The host setup (Algorithm 1), the numpy reference solve and the lowering
are numpy copies of the reference; the distributed solve phase runs on
rank-stacked tensors through the CUDA kernels::

    from repro_torch.amg import AMGConfig, AMGSolver

    cfg = AMGConfig(backend="torch", n_pods=2, lanes=4, dtype="float64")
    res = AMGSolver(cfg).setup(A).pcg(b)

On the card each solve program runs as a captured CUDA graph; ``update``
streams value-only changes beneath those graphs, and :class:`AMGService`
coalesces requests into the multi-RHS programs.

``AMGConfig(setup_backend="dist", backend="torch")`` additionally runs the
**setup phase** partitioned (:mod:`repro_torch.amg.dist_setup`, host
numpy): the Galerkin SpGEMMs A·P and Pᵀ·(AP) exchange off-process CSR rows
under model-selected standard/NAP-2/NAP-3 schedules and every level is born
partitioned, lowered straight onto the card with no host ``Hierarchy``.
"""
from .api import (AMGConfig, AMGService, AMGSolver, BoundSolver,
                  PatternMismatch, RefreshPolicy, RequestOptions,
                  ServiceReport, SessionStore, Ticket, available_backends,
                  register_backend)
from .csr import CSR
from .dist_solve import DistHierarchy
from .hierarchy import Hierarchy, Level, setup
from .solve import (MultiSolveResult, SolveOptions, SolveResult, pcg, solve,
                    vcycle)

__all__ = ["CSR", "Hierarchy", "Level", "setup", "SolveOptions", "SolveResult",
           "MultiSolveResult", "pcg", "solve", "vcycle", "AMGConfig",
           "AMGService", "AMGSolver", "BoundSolver", "PatternMismatch",
           "RefreshPolicy", "RequestOptions", "ServiceReport",
           "SessionStore", "Ticket",
           "available_backends", "register_backend", "DistHierarchy"]

# NOTE: the partitioned setup's entry point is deliberately NOT re-exported
# here — a ``dist_setup`` attribute would collide with the
# ``repro_torch.amg.dist_setup`` submodule name and get rebound to the module
# by the import system.  Import it as ``from repro_torch.amg.dist_setup
# import dist_setup`` (or go through ``AMGConfig(setup_backend="dist")``).
