"""Model-layout adapter (the port's copy of ``repro/kernels/ssd/ops.py``).

``ssd_chunked`` takes the model layout of :mod:`repro_torch.models.ssd`
and hands transposed views to :func:`~.kernel.ssd_chunked_bhtp` (the
kernel on CUDA tensors, the plain version on CPU tensors).  The kernel
reads the views through their strides and writes ``y`` into
``(b, t, h, p)`` storage, so neither direction copies on the card.
"""

from __future__ import annotations

from repro_torch.kernels.ssd.kernel import ssd_chunked_bhtp


def ssd_chunked(xh, dt, a, B, C, s0, *, chunk: int = 64):
    """Model layout: xh (b,t,h,p), dt/a (b,t,h), B/C (b,t,n), s0 (b,h,p,n).
    Returns (y (b,t,h,p), state (b,h,p,n))."""
    y, s = ssd_chunked_bhtp(xh.transpose(1, 2), dt.transpose(1, 2),
                            a.transpose(1, 2), B, C, s0, chunk=chunk)
    return y.transpose(1, 2), s
