"""The port's boundaries: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package, the entry points refuse to run
without a card unless asked for the CPU, and what this slice does not port
yet raises instead of running something else."""
import ast
import os
import pathlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.amg import AMGConfig, AMGSolver, SolveOptions  # noqa: E402
from repro_torch.amg.dist_solve import DistHierarchy  # noqa: E402
from repro_torch.amg.hierarchy import setup  # noqa: E402
from repro_torch.amg.problems import laplace_3d  # noqa: E402

ROOT = pathlib.Path(__file__).parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_imports_without_jax_or_the_reference():
    """Every port module and chip_smoke.py's own imports load with ``jax``
    and ``repro`` made unimportable."""
    mods = _modules()
    assert len(mods) >= 73, mods
    code = "\n".join([
        "import sys",
        "for name in ('jax', 'jaxlib', 'repro'):",
        "    sys.modules[name] = None",
        "import importlib",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        f"sys.path.insert(0, {str(ROOT)!r})",
        "import chip_smoke",
        "assert not [m for m, v in sys.modules.items() if v is not None and"
        " m.split('.')[0] in ('jax', 'jaxlib', 'repro')]",
        "print('IMPORTED', len(sys.modules))",
    ])
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "IMPORTED" in out.stdout


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    bad = [n for n in _imported_names(path)
           if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_torch_backend_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AMGConfig(backend="torch")                 # default device="cuda"
    h = setup(laplace_3d(6), max_coarse=30)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        DistHierarchy.build(h, 2, 4)               # default device="cuda"
    # asking for the CPU explicitly is the only way onto it
    cfg = AMGConfig(backend="torch", n_pods=2, lanes=4, device="cpu",
                    dtype="float64", max_coarse=30)
    res = AMGSolver(cfg).setup(laplace_3d(6)).pcg(np.ones(216))
    assert res.converged
    assert AMGConfig(backend="host").device == "cuda"   # host ignores it


def test_unported_parts_raise():
    with pytest.raises(NotImplementedError, match="bfloat16"):
        AMGConfig(backend="torch", dtype="bfloat16", device="cpu")
    # the partitioned setup is ported: accepted on the torch backend, and
    # refused, as the reference refuses it, on another backend or for SA
    assert AMGConfig(backend="torch", setup_backend="dist",
                     device="cpu").setup_backend == "dist"
    with pytest.raises(ValueError, match="backend='torch'"):
        AMGConfig(backend="host", setup_backend="dist")
    with pytest.raises(ValueError, match="solver='rs'"):
        AMGConfig(backend="torch", setup_backend="dist", solver="sa",
                  device="cpu")
    with pytest.raises(ValueError):
        AMGConfig(backend="torch", device="meta")
    A = laplace_3d(6)
    cfg = AMGConfig(backend="torch", n_pods=2, lanes=4, device="cpu",
                    max_coarse=30)
    bound = AMGSolver(cfg).setup(A)
    assert bound.update(A) == "refresh"          # streaming updates: ported
    b = np.ones(A.nrows)
    # the block smoothers are ported: one sweep of each runs on the CPU
    # and reduces the residual
    for sm in ("block_jacobi", "hybrid_gs", "hybrid_gs_sym"):
        res = AMGSolver(cfg.replace(opts=SolveOptions(smoother=sm))) \
            .setup(A).solve(b, tol=0.0, maxiter=1)
        assert len(res.residuals) == 2 and res.residuals[1] < res.residuals[0]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        DistHierarchy.build(bound.hierarchy, 2, 4, dtype=torch.bfloat16,
                            device="cpu")


def test_lm_entry_points_refuse_cuda_without_a_card(monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_lm
    from repro_torch.serve import Engine

    cfg = get_arch("qwen3-1.7b").reduced(n_layers=2, d_model=32, n_heads=4,
                                        vocab=64)
    model = init_lm(cfg, dtype=torch.float32, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(cfg)                                # default device="cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced"])
    # asking for the CPU explicitly is the only way onto it
    assert Engine(cfg, model, device="cpu").device.type == "cpu"


def test_amg_serving_is_not_ported_yet(monkeypatch):
    """AMG serving is ported now: ``--solver amg`` runs on the card by
    default and refuses a machine without one; the reference's JAX ``dist``
    backend is not a backend of the port."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit):
        serve.main(["--solver", "amg", "--amg-backend", "dist"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--solver", "amg"])
