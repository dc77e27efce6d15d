"""Kernels of the port: each a hand-written CUDA kernel for Hopper beside
its plain PyTorch version, mirroring ``repro.kernels``."""

import torch

from repro_torch import KernelInputError

#: Chunk lengths the chunked-scan kernels (K3, K4) are built for.
CHUNKS = (16, 32, 64)


def chunk_tile(c: int, t: int) -> int:
    """A chunked-scan kernel's chunk tile for the reference's chunk length
    ``c = min(chunk, t)``: a single short chunk (``c == t``) runs in the
    smallest tile that holds it, its extra rows masked as the padding they
    equal."""
    if c in CHUNKS:
        return c
    if c == t and t < CHUNKS[-1]:
        return min(v for v in CHUNKS if v >= t)
    raise ValueError(f"chunk length {c} not in {CHUNKS}")


def aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` if a chunked-scan kernel's 16-byte loads can read it in place
    (last dim contiguous; base and row strides multiples of 16 bytes),
    else a contiguous copy."""
    size = x.element_size()
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
            s * size % 16 == 0 for s in x.stride()[:-1]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record through kernel ``name``.  The
    kernels fill fresh outputs through ctypes, so their results carry no
    ``grad_fn``, and the reference defines no backward for any of them: a
    training step through one would drop every gradient upstream of it
    without a word.  Under ``torch.no_grad()`` (serving, eval) they run."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise KernelInputError(
            f"{name} has no backward (nor has the reference's kernel): it "
            "refuses inputs that require grad while grad mode is on; train "
            "through the plain route, or call it under torch.no_grad()")
