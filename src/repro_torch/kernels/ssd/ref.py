"""Plain oracle for the ssd kernel (the port's copy of
``repro/kernels/ssd/ref.py``): the sequential scan of
:mod:`repro_torch.models.ssd` in the kernel's (b, h, t, p) layout."""

from __future__ import annotations

from repro_torch.models.ssd import ssd_scan_ref


def ssd_ref(x, dt, a, B, C, s0):
    """(b,h,t,p) layout -> (y, final_state), f32."""
    to_bt = lambda v: v.transpose(1, 2).float()   # (b,h,t,*) -> (b,t,h,*)
    y, s = ssd_scan_ref(to_bt(x), to_bt(dt), to_bt(a), B.float(), C.float(),
                        s0.float())
    return y.transpose(1, 2), s
