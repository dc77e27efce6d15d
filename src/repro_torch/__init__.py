"""PyTorch/CUDA port of the size-based MapReduce scheduling reproduction.

``repro_torch`` mirrors the layout of the JAX package ``repro`` module by
module, so each part of the port sits where its reference counterpart
does.  It imports ``torch`` and numpy only: never ``jax`` and nothing of
``repro``.  Plain-Python modules the port needs (workload generator,
scenario specs) are kept here as copies.

Device rule: every entry point runs on ``device="cuda"`` unless the
caller asks for ``device="cpu"``.  When CUDA is asked for and absent,
:func:`resolve_device` raises — nothing quietly continues on the CPU.
"""

from __future__ import annotations

import torch


class DeviceError(RuntimeError):
    """The device a call asked for is missing, or a kernel of the port
    failed on it.  A failure of the machine, not of the inputs: the sweep
    fabric ends a run on it instead of retrying, demoting or quarantining
    the cell (:func:`is_device_failure`)."""


class KernelError(DeviceError):
    """A kernel of the port failed to build (``nvcc``) or to launch."""


class KernelInputError(KernelError, ValueError, TypeError):
    """A kernel's wrapper was handed tensors outside its contract (shape,
    dtype, device, width).  The port builds those tensors, so this is a
    fault of the port, not of a cell: to the sweep fabric it is a
    :class:`KernelError`, and it stays the ``ValueError`` or ``TypeError``
    that callers checking their inputs expect."""


def is_device_failure(exc: BaseException) -> bool:
    """True for a failure of the card or of a kernel of the port: a
    :class:`DeviceError`, a CUDA out-of-memory error, or an error the CUDA
    runtime raised through torch."""
    kinds = (DeviceError, torch.OutOfMemoryError)
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        kinds += (accel,)
    return isinstance(exc, kinds)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` to run on; raises if it is a CUDA device and
    this process has none (a :class:`DeviceError`; pass ``device="cpu"``
    to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
