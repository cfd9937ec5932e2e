"""Meshes of ``torch.distributed`` ranks, axes ``("data", "model")``.

The counterpart of the reference's ``launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the current process
group: the caller starts the ranks (``torch.multiprocessing.spawn`` in
the tests and ``chip_smoke.py``) and each calls
``torch.distributed.init_process_group`` with its rank, the world size
and a rendezvous (``init_method="file://..."`` or a ``FileStore``), then
``make_mesh``.  The per-axis process groups come from the mesh
(``mesh.get_group("model")``); ``models/sharding.py::Policy`` reads them.

Device and backend are explicit.  ``device_type=None`` means ``cuda``
and raises without a card (pass ``device_type="cpu"``), as
``repro_torch/device.py`` does.  ``backend=None`` means NCCL on ``cuda``
and gloo on ``cpu``; gloo on ``cuda`` (collectives staged through host
memory, several ranks on one card) is used only when asked for by name.
The default group must run the backend the mesh resolves to.

The flattened ``("data", "model")`` axes of the training ``fsdp``
scheme (batch and ZeRO-3 over every rank) are the whole mesh: the policy
runs their collectives over the world group, whose ranks are in the
mesh's row-major order (``models/sharding.py::Policy.group``).

``make_production_mesh`` gives the reference's production shape and axes
only: building it needs that many ranks, which no machine of this port
has yet (ROADMAP queue 1, item 19).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def resolve_backend(device_type=None, backend=None):
    """(device type, backend) of a mesh: ``cuda`` unless asked for the
    CPU (raising without a card), NCCL on ``cuda`` and gloo on ``cpu``
    unless ``backend`` names one."""
    if device_type is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device_type=\"cpu\" "
                           "to run the mesh on the CPU (gloo)")
    device_type = resolve_device(device_type or "cuda").type
    backend = backend or BACKENDS[device_type]
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}: use nccl or gloo")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("NCCL runs on cuda only: pass backend=\"gloo\" for the CPU")
    return device_type, backend


def make_mesh(shape, axes=("data", "model"), *, device_type=None, backend=None):
    """A ``DeviceMesh`` of ``shape`` over the current process group, whose
    size must be ``prod(shape)`` and whose backend must be the resolved
    ``backend``."""
    device_type, backend = resolve_backend(device_type, backend)
    if not dist.is_initialized():
        raise RuntimeError(
            f"no process group: call torch.distributed.init_process_group("
            f"{backend!r}, ...) in every rank before make_mesh")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} ranks; the "
                         f"process group has {dist.get_world_size()}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, the mesh "
                         f"asks for {backend!r}: pass backend={dist.get_backend()!r} "
                         "to run the mesh over it")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """(shape, axes) of the reference's production mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_test_mesh(shape=(1, 1), axes=("data", "model"), *, device_type=None,
                   backend=None):
    """A small mesh over the current process group."""
    return make_mesh(shape, axes, device_type=device_type, backend=backend)


def data_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def model_axis_size(mesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("model"))

