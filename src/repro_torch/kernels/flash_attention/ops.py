"""Model-layout adapter (the port's copy of
``repro/kernels/flash_attention/ops.py``).

``flash_attention`` takes the model layout ``(b, s, h, hd)`` used
everywhere in :mod:`repro_torch.models` and hands transposed views to
:func:`~.kernel.flash_attention_bhsd` (the kernel on CUDA tensors, the
plain version on CPU tensors); ``flash_attention_reference`` does the
same through the oracle.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(
    q: torch.Tensor,   # (b, sq, h, hd)
    k: torch.Tensor,   # (b, skv, kvh, hd)
    v: torch.Tensor,
    *,
    mask=None,         # accepted for API parity; the kernel derives its own mask
    scale: float,
    causal: bool = True,
    window: int | None = None,
    block_q: int = 512,
    block_kv: int = 512,
) -> torch.Tensor:
    out = flash_attention_bhsd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        scale=scale, causal=causal, window=window,
        block_q=block_q, block_kv=block_kv,
    )
    return out.transpose(1, 2)


def flash_attention_reference(q, k, v, *, scale, causal=True, window=None, **_):
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), scale=scale, causal=causal,
                        window=window)
    return out.transpose(1, 2)
