"""Mamba2 / SSD (state-space dual) blocks, used by the zamba2 hybrid (the
port's copy of ``repro/models/ssd.py``).

Per head h (head dim P, state dim N), with scalar decay per head/step:

    a_t = exp(-exp(A_log_h) * dt_t)                  (data-dependent, scalar)
    h_t = a_t * h_{t-1} + dt_t * (x_t ⊗ B_t)         (h: P x N)
    y_t = h_t C_t + D_h * x_t

dt_t = softplus(dt_proj(u) + dt_bias); B, C are shared across heads
(multi-value attention analogy).  A short causal conv (window 4) precedes
the SSM — its tail is the decode-time "conv state".

Three compute paths, as in the reference:

* ``ssd_scan_ref``      — the sequential oracle (a Python loop over t;
  decode runs it with t = 1);
* ``ssd_scan_chunked``  — the chunked parallel form (the default);
* ``repro_torch.kernels.ssd`` — kernel K4 on CUDA tensors, selected by
  ``ssd_block(use_kernel=True)`` (the reference's ``use_pallas``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import _full, dense_init, gen_device
from repro_torch.models.spmd import einsum, pad_seq

CONV_K = 4


def init_ssd_block(cfg: ModelConfig, gen: torch.Generator, *,
                   layers: int | None = None) -> dict:
    d, pdt, dev = cfg.d_model, cfg.param_dtype, gen_device(gen)
    d_inner = cfg.ssm_expand * d
    n = cfg.ssm_state
    heads = d_inner // cfg.ssm_head_dim
    pref = () if layers is None else (layers,)
    # Per-component projections (z, x, B, C, dt) and depthwise convs, as
    # the reference keeps them.
    return {
        "wz": dense_init(gen, (*pref, d, d_inner), d, pdt),
        "wx": dense_init(gen, (*pref, d, d_inner), d, pdt),
        "wB": dense_init(gen, (*pref, d, n), d, pdt),
        "wC": dense_init(gen, (*pref, d, n), d, pdt),
        "wdt": dense_init(gen, (*pref, d, heads), d, pdt),
        "conv_x_w": dense_init(gen, (*pref, CONV_K, d_inner), CONV_K, pdt),
        "conv_x_b": _full((*pref, d_inner), 0.0, pdt, dev),
        "conv_B_w": dense_init(gen, (*pref, CONV_K, n), CONV_K, pdt),
        "conv_B_b": _full((*pref, n), 0.0, pdt, dev),
        "conv_C_w": dense_init(gen, (*pref, CONV_K, n), CONV_K, pdt),
        "conv_C_b": _full((*pref, n), 0.0, pdt, dev),
        "A_log": _full((*pref, heads), 0.0, pdt, dev),
        "D": _full((*pref, heads), 1.0, pdt, dev),
        "dt_bias": _full((*pref, heads), 0.0, pdt, dev),
        "w_out": dense_init(gen, (*pref, d_inner, d), d_inner, pdt),
        "norm_scale": _full((*pref, d_inner), 1.0, pdt, dev),
    }


def init_ssd_state(cfg: ModelConfig, batch: int, *, layers: int,
                   device) -> dict:
    d_inner = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    heads = d_inner // cfg.ssm_head_dim
    act = cfg.activation_dtype()
    conv = lambda c: torch.zeros((layers, batch, CONV_K - 1, c), dtype=act,
                                 device=device)
    return {
        "ssm": torch.zeros((layers, batch, heads, cfg.ssm_head_dim, n),
                           dtype=torch.float32, device=device),
        "conv_x": conv(d_inner),
        "conv_B": conv(n),
        "conv_C": conv(n),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` as it computes it: ``max(x, 0) + log1p(exp(-|x|))``.
    ``F.softplus`` switches to ``x`` itself above ``threshold=20``; in f32
    the two differ by less than 1e-8 there, but this keeps the formula."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, window CONV_K.  x: (b, t, c); state: (b, K-1, c)
    carries the previous K-1 inputs.  Returns (y, new_state), the new state
    being the last K-1 inputs in x's dtype."""
    full = torch.cat([state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(CONV_K):
        y = y + full[:, i:i + t, :] * w[i].to(x.dtype)
    y = F.silu(y + b.to(x.dtype))
    return y, full[:, -(CONV_K - 1):, :]


# ---------------------------------------------------------------------------
# SSD scans
# ---------------------------------------------------------------------------
def ssd_scan_ref(xh, dt, a, B, C, state):
    """Sequential oracle.  xh: (b,t,h,p); dt,a: (b,t,h); B,C: (b,t,n);
    state: (b,h,p,n).  Returns (y, final_state)."""
    S = state
    ys = []
    for t in range(xh.shape[1]):
        dBx = (xh[:, t] * dt[:, t, :, None])[..., None] * B[:, t, None, None, :]
        S = a[:, t, :, None, None] * S + dBx
        ys.append(einsum("bhpn,bn->bhp", S, C[:, t]))
    return torch.stack(ys, dim=1), S


def ssd_scan_chunked(xh, dt, a, B, C, state, chunk: int = 64):
    """Chunked parallel SSD form (identical math to the ref).

    With per-(token,head) scalar decays a_t and L_t = prod_{i<=t} a_i:

      intra: y_t += sum_{j<=t} (L_t / L_j) dt_j (C_t · B_j) x_j
      inter: y_t += L_t^{pre} * (S_in C_t)
      state: S_out = L_c S_in + sum_j (L_c / L_j) dt_j x_j B_j^T

    A ragged t is padded with a = 1 and x = dt = B = C = 0, as in the
    reference.
    """
    b, t, h, p = xh.shape
    n = B.shape[-1]
    pad = (-t) % chunk
    if pad:
        xh = pad_seq(xh, pad)
        dt = pad_seq(dt, pad)
        a = pad_seq(a, pad, value=1.0)
        B = pad_seq(B, pad)
        C = pad_seq(C, pad)
    tc = xh.shape[1] // chunk
    xc = xh.reshape(b, tc, chunk, h, p).float()
    dtc = dt.reshape(b, tc, chunk, h)
    Bc = B.reshape(b, tc, chunk, n).float()
    Cc = C.reshape(b, tc, chunk, n).float()

    loga = torch.log(torch.clamp(a.reshape(b, tc, chunk, h).float(),
                                 min=1e-38))
    cum = torch.cumsum(loga, dim=2)          # L_t (inclusive)
    total = cum[:, :, -1, :]                 # (b, tc, h)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))           # j <= t
    S = state
    ys = []
    for i in range(tc):
        xcu, dtu, Bu, Cu = xc[:, i], dtc[:, i], Bc[:, i], Cc[:, i]
        cumu, totu = cum[:, i], total[:, i]
        ratio = torch.exp(cumu[:, :, None, :] - cumu[:, None, :, :])  # (b,t,j,h)
        ratio = torch.where(tri[None, :, :, None], ratio, 0.0)
        cb = einsum("bin,bjn->bij", Cu, Bu)
        scores = ratio * cb[..., None] * dtu[:, None, :, :]         # (b,t,j,h)
        y_intra = einsum("btjh,bjhp->bthp", scores, xcu)
        y_inter = einsum("bhpn,bcn,bch->bchp", S, Cu, torch.exp(cumu))
        S = torch.exp(totu)[:, :, None, None] * S + einsum(
            "bch,bchp,bcn->bhpn",
            dtu * torch.exp(totu[:, None, :] - cumu), xcu, Bu,
        )
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, tc * chunk, h, p)
    return y[:, :t], S


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def ssd_block(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,
    state: dict,
    *,
    use_ref: bool = False,
    use_kernel: bool = False,
) -> tuple[torch.Tensor, dict]:
    """state: {"ssm": (b,h,p,n) f32, "conv_x"/"conv_B"/"conv_C": (b, K-1, c)}.

    ``use_kernel`` routes the scan to
    :func:`repro_torch.kernels.ssd.ops.ssd_chunked` (K4 on CUDA tensors),
    the reference's ``use_pallas`` route: x, B and C go over in the
    activation dtype, dt and a in f32, chunk 64 (not ``cfg.inner_chunk``),
    and ``y`` comes back rounded to the activation dtype before the ``D``
    skip is added.  The other two routes take f32 inputs and add the skip
    to an f32 ``y``."""
    b, t, d = x.shape
    d_inner = cfg.ssm_expand * d
    p_dim = cfg.ssm_head_dim
    heads = d_inner // p_dim
    dtype = x.dtype

    z = x @ p["wz"].to(dtype)
    x_p = x @ p["wx"].to(dtype)
    B_p = x @ p["wB"].to(dtype)
    C_p = x @ p["wC"].to(dtype)
    dt_raw = x @ p["wdt"].to(dtype)
    x_in, cs_x = causal_conv(x_p, p["conv_x_w"], p["conv_x_b"], state["conv_x"])
    B, cs_B = causal_conv(B_p, p["conv_B_w"], p["conv_B_b"], state["conv_B"])
    C, cs_C = causal_conv(C_p, p["conv_C_w"], p["conv_C_b"], state["conv_C"])
    dt = softplus(dt_raw.float() + p["dt_bias"].float())      # (b, t, h)
    a = torch.exp(-torch.exp(p["A_log"].float())[None, None, :] * dt)
    xh = x_in.reshape(b, t, heads, p_dim)

    if use_kernel:
        from repro_torch.kernels.ssd.ops import ssd_chunked

        y, S = ssd_chunked(xh, dt, a, B, C, state["ssm"])
    elif use_ref:
        y, S = ssd_scan_ref(xh.float(), dt, a, B.float(), C.float(),
                            state["ssm"])
    else:
        y, S = ssd_scan_chunked(xh.float(), dt, a, B.float(), C.float(),
                                state["ssm"], chunk=cfg.inner_chunk)
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, t, d_inner).to(dtype)
    # Gated RMSNorm (mamba2's norm-before-out-proj), its eps fixed at 1e-5.
    y = y * F.silu(z)
    var = y.float().square().mean(dim=-1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + 1e-5)).to(dtype)
    y = y * p["norm_scale"].to(dtype)
    out = y @ p["w_out"].to(dtype)
    return out, {"ssm": S, "conv_x": cs_x, "conv_B": cs_B, "conv_C": cs_C}
