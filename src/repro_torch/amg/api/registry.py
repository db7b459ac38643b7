# Verbatim copy of repro/amg/api/registry.py (numpy only); only the imports may differ.
"""Backend registry: how solver implementations plug into the session API.

A backend is a :class:`~repro.amg.api.sessions.BoundSolver` subclass
registered under a name; ``AMGConfig(backend=name)``, the free functions
``solve``/``pcg``/``vcycle`` and the serving surface
(:class:`~repro.amg.api.service.AMGService`) all resolve implementations
through this table, so new backends (an SA variant, say) plug in without
touching any call site.
"""
from __future__ import annotations

_BACKENDS: dict[str, type] = {}


def register_backend(name: str):
    """Class decorator: make a :class:`BoundSolver` subclass reachable as
    ``AMGConfig(backend=name)`` / ``solve(..., backend=name)``."""
    def deco(cls):
        cls.backend_name = name
        _BACKENDS[name] = cls
        return cls
    return deco


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def backend_class(name: str) -> type:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; registered backends: "
                         f"{available_backends()}") from None


def bind_hierarchy(h, backend: str = "host", dist=None, opts=None):
    """Wrap an existing host hierarchy in the named backend's bound solver.

    This is what the free functions ``solve`` / ``pcg`` / ``vcycle`` call;
    ``dist=`` carries the legacy prebuilt-``DistHierarchy``-or-kwargs-dict
    argument (dict kwargs hit the per-hierarchy cache).
    """
    return backend_class(backend).from_hierarchy(h, dist=dist, opts=opts)
