"""Plain oracle for the rwkv6 kernel (the port's copy of
``repro/kernels/rwkv6/ref.py``): the sequential scan of
:mod:`repro_torch.models.rwkv` in the kernel's (b, h, t, d) layout."""

from __future__ import annotations

from repro_torch.models.rwkv import rwkv_scan_ref


def rwkv6_ref(r, k, v, w, u, s0):
    """(b,h,t,d) layout -> (out, final_state), f32."""
    to_bt = lambda x: x.transpose(1, 2).float()   # (b,h,t,d) -> (b,t,h,d)
    out, s = rwkv_scan_ref(to_bt(r), to_bt(k), to_bt(v), to_bt(w),
                           u.float(), s0.float())
    return out.transpose(1, 2), s
