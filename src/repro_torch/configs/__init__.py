# Verbatim copy of repro/configs/__init__.py (plain data); only the imports may differ.
"""Config registry: ``--arch <id>`` lookup + input-shape suite."""
from .archs import ARCHS
from .base import SHAPES, ArchConfig, ShapeConfig


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def cells():
    """All assigned (arch × shape) cells, with long_500k skips applied."""
    out = []
    for a in ARCHS.values():
        for s in SHAPES.values():
            if s.name == "long_500k" and not a.sub_quadratic:
                out.append((a, s, "skip: full attention (DESIGN.md §5)"))
            else:
                out.append((a, s, None))
    return out


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "get_arch",
           "get_shape", "cells"]
