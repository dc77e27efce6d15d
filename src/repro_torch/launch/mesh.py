"""Mesh construction (the port's copy of ``repro/launch/mesh.py``), on
:class:`~torch.distributed.device_mesh.DeviceMesh`.

Single pod: (data=16, model=16) = 256 devices.
Multi-pod:  (pod=2, data=16, model=16) = 512 devices — the "pod" axis is
pure data parallelism across the slower links between pods; "model" stays
inside a pod.

The production meshes are never backed by devices: they live in a *fake*
process group (``torch.testing._internal.distributed.fake_pg``), this
process being rank 0 of 512 ranks whose collectives do nothing, and they
hold ``meta`` tensors (the counterpart of the reference's 512 forced host
devices).  Both production meshes fit one fake world of 512 ranks: the
single-pod mesh is ranks 0..255 of it, as a device mesh may cover part of
its world.  :func:`fake_world` starts that group and tears it down.

Everything here is a function: importing this module starts no process
group and touches no environment variable.

:func:`use_mesh` is the ambient mesh, the counterpart of the reference's
``with mesh:``; the MoE layer's group pin reads it
(:func:`current_mesh`).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import DeviceError, resolve_device

#: The largest production mesh: (pod=2, data=16, model=16).
PRODUCTION_WORLD = 512

_AMBIENT: list[DeviceMesh] = []


@contextlib.contextmanager
def fake_world(size: int = PRODUCTION_WORLD):
    """A fake process group of ``size`` ranks, this process rank 0, for the
    duration of the block; destroyed on exit.  Refuses to start inside
    another process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; a fake "
                           "world needs the process to itself")
    dist.init_process_group("fake", store=FakeStore(), world_size=size,
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cpu") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over ranks ``0..prod(shape)-1`` of
    the current process group (a :func:`fake_world` for anything wider than
    the devices really there)."""
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"make_mesh{tuple(shape)} needs a process group "
                           "of at least that many ranks: enter "
                           "fake_world() first")
    if dist.get_world_size() < n:
        raise RuntimeError(f"a mesh of {n} devices does not fit a world of "
                           f"{dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model: int = 1, device: str | torch.device = "cuda"
                   ) -> DeviceMesh:
    """Mesh over the devices really there (tests/examples): one per rank of
    the current process group, or, with none, a process group of this one
    process and its one device.  On the card that is a (1, 1) ``cuda``
    mesh.  Raises :class:`~repro_torch.DeviceError` without a card unless
    ``device="cpu"``.  :func:`close_host_mesh` ends the group it started."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend == "nccl" and not dist.is_nccl_available():
            raise DeviceError("this torch has no NCCL for a cuda mesh")
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model={model} does not divide {n} devices")
    return init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def close_host_mesh() -> None:
    """End the process group :func:`make_host_mesh` started."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh):
    """Make ``mesh`` the ambient mesh for the block (the reference's
    ``with mesh:``)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh() -> DeviceMesh | None:
    """The innermost :func:`use_mesh` mesh, or None."""
    return _AMBIENT[-1] if _AMBIENT else None
