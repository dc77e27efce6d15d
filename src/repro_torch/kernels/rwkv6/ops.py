"""Model-layout adapter (the port's copy of ``repro/kernels/rwkv6/ops.py``).

``rwkv6_chunked`` takes the model layout ``(b, t, h, d)`` of
:mod:`repro_torch.models.rwkv` and hands transposed views to
:func:`~.kernel.rwkv6_chunked_bhtd` (the kernel on CUDA tensors, the plain
version on CPU tensors).  The kernel reads the views through their
strides and writes its output into ``(b, t, h, dv)`` storage, so neither
direction copies on the card.
"""

from __future__ import annotations

from repro_torch.kernels.rwkv6.kernel import rwkv6_chunked_bhtd


def rwkv6_chunked(r, k, v, w, u, s0, *, chunk: int = 64):
    """Model layout (b, t, h, d) -> (out (b, t, h, dv), state (b, h, dk, dv))."""
    to_bh = lambda x: x.transpose(1, 2)
    out, s = rwkv6_chunked_bhtd(to_bh(r), to_bh(k), to_bh(v), to_bh(w), u, s0,
                                chunk=chunk)
    return out.transpose(1, 2), s
