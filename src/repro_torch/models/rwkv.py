"""RWKV6 "Finch" blocks (arXiv:2404.05892), the port's copy of
``repro/models/rwkv.py``: attention-free token mixing with data-dependent
per-channel decay.

Per head (key/value dims D):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state update)
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)     (readout with bonus u)

with w_t = exp(-exp(ww_t)) computed from the token (data-dependent decay),
and token-shift interpolation x'_t = lerp(x_t, x_{t-1}, mu) feeding every
projection (r, k, v, g, w).

Three compute paths, as in the reference:

* ``rwkv_scan_ref``      — the sequential oracle (a Python loop over t;
  decode runs it with t = 1);
* ``rwkv_scan_chunked``  — the chunked parallel form (the default);
* ``repro_torch.kernels.rwkv6`` — kernel K3 on CUDA tensors, selected by
  ``rwkv_time_mix(use_kernel=True)`` (the reference's ``use_pallas``).

Decode keeps ``(S, shift)`` recurrent state, O(1) per token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import _full, dense_init, gen_device
from repro_torch.models.spmd import einsum, pad_seq


def init_rwkv_block(cfg: ModelConfig, gen: torch.Generator, *,
                    layers: int | None = None) -> dict:
    d, dt, dev = cfg.d_model, cfg.param_dtype, gen_device(gen)
    pref = () if layers is None else (layers,)
    heads = d // cfg.rwkv_head_dim
    return {
        # token-shift mixing coefficients per projection
        "mu": _full((*pref, 5, d), 0.5, dt, dev),
        "wr": dense_init(gen, (*pref, d, d), d, dt),
        "wk": dense_init(gen, (*pref, d, d), d, dt),
        "wv": dense_init(gen, (*pref, d, d), d, dt),
        "wg": dense_init(gen, (*pref, d, d), d, dt),
        # data-dependent decay: low-rank ww = tanh(x' A) B + bias
        "wd_a": dense_init(gen, (*pref, d, 64), d, dt),
        "wd_b": dense_init(gen, (*pref, 64, d), 64, dt),
        "wd_bias": _full((*pref, d), -6.0, dt, dev),
        "bonus_u": _full((*pref, heads, cfg.rwkv_head_dim), 0.0, dt, dev),
        "wo": dense_init(gen, (*pref, d, d), d, dt),
        "ln_x_scale": _full((*pref, d), 1.0, dt, dev),
    }


def init_channel_mix(cfg: ModelConfig, gen: torch.Generator, *,
                     layers: int | None = None) -> dict:
    d, dff, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    pref = () if layers is None else (layers,)
    return {
        "mu": _full((*pref, 2, d), 0.5, dt, gen_device(gen)),
        "wk": dense_init(gen, (*pref, d, dff), d, dt),
        "wv": dense_init(gen, (*pref, dff, d), dff, dt),
        "wr": dense_init(gen, (*pref, d, d), d, dt),
    }


def init_rwkv_state(cfg: ModelConfig, batch: int, *, layers: int,
                    device) -> dict:
    h, dk = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    act = cfg.activation_dtype()
    return {
        "S": torch.zeros((layers, batch, h, dk, dk), dtype=torch.float32,
                         device=device),
        "shift": torch.zeros((layers, batch, cfg.d_model), dtype=act,
                             device=device),
        "cmix_shift": torch.zeros((layers, batch, cfg.d_model), dtype=act,
                                  device=device),
    }


def token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x_{t-1} stream: shift right by one, first slot = carry (b, d)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


# ---------------------------------------------------------------------------
# WKV scans
# ---------------------------------------------------------------------------
def rwkv_scan_ref(r, k, v, w, u, state):
    """Sequential oracle.  r,k,w: (b, t, h, dk); v: (b, t, h, dv);
    u: (h, dk); state: (b, h, dk, dv).  Returns (out, final_state)."""
    S = state
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (b,h,dk,dv)
        o_t = einsum("bhk,bhkv->bhv", r[:, t],
                           S + u[None, :, :, None] * kv)
        S = w[:, t, :, :, None] * S + kv
        outs.append(o_t)
    return torch.stack(outs, dim=1), S


def rwkv_scan_chunked(r, k, v, w, u, state, chunk: int = 64):
    """Chunked parallel form (mathematically identical to the ref).

    Within a chunk of length c, with cumulative decays
    A_t = prod_{i<=t} diag(w_i) (A_0 = I pre-token):

      o_t = r_t^T A_t^{pre} S_in + intra-chunk lower-triangular part
      S_out = A_c S_in + sum_t (prod_{i>t} w_i) k_t v_t^T

    The intra-chunk part is two (c x c) products per head.  The clamps
    (1e-38 on w, 1e-30 on the cumulative decay) and the w = 1 padding
    are the reference's.
    """
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    pad = (-t) % chunk
    if pad:
        r, k, v = (pad_seq(x, pad) for x in (r, k, v))
        w = pad_seq(w, pad, value=1.0)
    tc = r.shape[1] // chunk
    shape_c = (b, tc, chunk, h, dk)
    rc, kc, wc = r.reshape(shape_c), k.reshape(shape_c), w.reshape(shape_c)
    vc = v.reshape(b, tc, chunk, h, dv)

    logw = torch.log(torch.clamp(wc.float(), min=1e-38))
    cum = torch.cumsum(logw, dim=2)                   # A_t incl. token t
    total = cum[:, :, -1:]                            # full-chunk decay
    a_pre = torch.exp(cum - logw)                     # A_t pre-token
    a_post = torch.exp(total - cum)                   # decay from t -> end
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    S = state
    outs = []
    for i in range(tc):
        rcu, kcu, vcu, wu = rc[:, i], kc[:, i], vc[:, i], wc[:, i]
        # Inter-chunk: queries read the carried state through their decay.
        r_dec = rcu * a_pre[:, i].to(rcu.dtype)
        o_inter = einsum("bchk,bhkv->bchv", r_dec, S)
        # Intra-chunk: ratio form a_pre_i / (a_pre_j * w_j).
        k_dec = kcu * a_post[:, i].to(kcu.dtype)
        inv_k = kcu / torch.clamp((a_pre[:, i] * wu).to(kcu.dtype), min=1e-30)
        scores = einsum("bchk,bdhk->bhcd", r_dec, inv_k)
        scores = torch.where(tri, scores, 0.0)
        o_intra = einsum("bhcd,bdhv->bchv", scores, vcu)
        # Bonus diagonal term: u ⊙ k_t v_t^T read by r_t.
        diag = einsum("bchk,hk,bchk->bch", rcu, u.to(rcu.dtype), kcu)
        o_diag = diag[..., None] * vcu
        kv_end = einsum("bchk,bchv->bhkv", k_dec, vcu)
        S = torch.exp(total[:, i, 0])[..., None].to(S.dtype) * S + kv_end
        outs.append(o_inter + o_intra + o_diag)
    out = torch.stack(outs, dim=1).reshape(b, tc * chunk, h, dv)
    return out[:, :t], S


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _projections(cfg: ModelConfig, p, x: torch.Tensor, prev: torch.Tensor):
    dtype = x.dtype
    shifted = token_shift(x, prev)
    mu = p["mu"].to(dtype)  # (5, d)
    xr, xk, xv, xg, xw = (x + mu[i] * (shifted - x) for i in range(5))
    b, t, d = x.shape
    h, dk = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    r = (xr @ p["wr"].to(dtype)).reshape(b, t, h, dk)
    k = (xk @ p["wk"].to(dtype)).reshape(b, t, h, dk)
    v = (xv @ p["wv"].to(dtype)).reshape(b, t, h, dk)
    g = xg @ p["wg"].to(dtype)
    # ww in the activation dtype; only the decay itself is taken in f32.
    ww = (torch.tanh(xw @ p["wd_a"].to(dtype)) @ p["wd_b"].to(dtype)
          + p["wd_bias"].to(dtype))
    w = torch.exp(-torch.exp(ww.float())).reshape(b, t, h, dk)
    return r, k, v, g, w


def rwkv_time_mix(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,
    state: dict,
    *,
    use_ref: bool = False,
    use_kernel: bool = False,
) -> tuple[torch.Tensor, dict]:
    """state: {"S": (b,h,dk,dv), "shift": (b,d)}.  ``use_kernel`` routes
    the scan to :func:`repro_torch.kernels.rwkv6.ops.rwkv6_chunked` (K3
    on CUDA tensors; r, k, v in the activation dtype, chunk 64), the
    reference's ``use_pallas`` route."""
    b, t, d = x.shape
    r, k, v, g, w = _projections(cfg, p, x, state["shift"])
    u = p["bonus_u"].float()
    S0 = state["S"]
    if use_kernel:
        from repro_torch.kernels.rwkv6.ops import rwkv6_chunked

        out, S = rwkv6_chunked(r, k, v, w, u, S0)
    elif use_ref:
        out, S = rwkv_scan_ref(r.float(), k.float(), v.float(), w, u, S0)
    else:
        out, S = rwkv_scan_chunked(r.float(), k.float(), v.float(), w, u, S0,
                                   chunk=cfg.inner_chunk)
    out = out.reshape(b, t, d).to(x.dtype)
    # Per-head group norm (biased variance) then gate.
    hd = cfg.rwkv_head_dim
    out = out.reshape(b, t, d // hd, hd)
    mean = out.mean(dim=-1, keepdim=True)
    var = out.var(dim=-1, keepdim=True, correction=0)
    out = ((out - mean) * torch.rsqrt(var + 64e-5)).reshape(b, t, d)
    out = out * p["ln_x_scale"].to(out.dtype)
    out = out * F.silu(g)
    y = out @ p["wo"].to(out.dtype)
    return y, {"S": S, "shift": x[:, -1, :]}


def rwkv_channel_mix(cfg: ModelConfig, p, x: torch.Tensor,
                     shift_prev: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    dtype = x.dtype
    shifted = token_shift(x, shift_prev)
    mu = p["mu"].to(dtype)
    xk = x + mu[0] * (shifted - x)
    xr = x + mu[1] * (shifted - x)
    k = torch.square(torch.relu(xk @ p["wk"].to(dtype)))
    kv = k @ p["wv"].to(dtype)
    r = torch.sigmoid(xr @ p["wr"].to(dtype))
    return r * kv, x[:, -1, :]
