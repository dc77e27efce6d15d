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


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` to run on; raises if it is a CUDA device and
    this process has none (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
