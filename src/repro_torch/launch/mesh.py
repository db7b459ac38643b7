"""Device meshes (port of ``repro/launch/mesh.py``): the production meshes
of the dry-run as :class:`~torch.distributed.device_mesh.DeviceMesh` es.

The reference lowers a production cell on 256 or 512 placeholder devices.
The port's counterpart is a *fake* process group (``"fake"`` backend,
``torch.testing._internal.distributed.fake_pg``; :func:`~repro_torch.core.
nap_collectives.start_fake_group`) of that many ranks, seen
from rank 0: every collective returns at once without moving data, so a
DTensor trace under ``FakeTensorMode`` runs the production mesh in one
process with no device memory.

A process has one default group.  :func:`make_mesh` with ``fake=True``
tears the current default group down (``destroy_process_group``) and
starts a new fake one whenever the size differs, so one process can move
between mesh sizes (the dry-run walks the 16x16 and 2x16x16 meshes in
turn).  A real group (``fake=False``) is the caller's: it must already be
initialised with the mesh's number of ranks, and :func:`make_mesh` never
replaces it.  The reference's small-mesh script runs one subprocess per
device count instead, because JAX fixes its device count at first use.
"""
from __future__ import annotations

import math

from torch.distributed.device_mesh import DeviceMesh

from ..core.nap_collectives import (default_world_size, device_mesh,
                                    start_fake_group)

PROD_SHAPE = {False: (16, 16), True: (2, 16, 16)}
PROD_AXES = {False: ("data", "model"), True: ("pod", "data", "model")}


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...], *,
              device_type: str = "cuda", fake: bool = True) -> DeviceMesh:
    """A mesh of ``shape`` over the axes ``names`` (row-major over the
    ranks, as ``jax.make_mesh`` lays out devices).  ``fake``: on a fake
    group of ``prod(shape)`` ranks (started here); else on the caller's
    initialised group, which must have that many ranks."""
    n = math.prod(shape)
    if fake:
        start_fake_group(n)
    elif default_world_size() != n:
        raise RuntimeError(f"make_mesh(fake=False): mesh {shape} needs an "
                           f"initialised process group of {n} ranks")
    return device_mesh(device_type, shape, names)


def make_production_mesh(multi_pod: bool = False, *, device_type: str = "cuda",
                         fake: bool = True) -> DeviceMesh:
    """16x16 = 256 devices a pod over ("data", "model"); ``multi_pod``: 2
    pods, 512 devices, over ("pod", "data", "model").  "pod" is the slow,
    inter-node domain; "data" and "model" are inside a pod."""
    return make_mesh(PROD_SHAPE[multi_pod], PROD_AXES[multi_pod],
                     device_type=device_type, fake=fake)


def mesh_sizes(mesh: DeviceMesh) -> dict[str, int]:
    """``{axis name: size}`` (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_axes_of(mesh: DeviceMesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def pod_size_of(mesh: DeviceMesh) -> int:
    """Devices a pod (for the pod-crossing classification of collectives)."""
    n = mesh.mesh.numel()
    return n // mesh_sizes(mesh)["pod"] if "pod" in mesh.mesh_dim_names else n
