"""Public model API of the port (``repro/models/api.py``): one entry point
per model operation, dispatched on ``cfg.family``: the encoder-decoder
family (whisper) to :mod:`.encdec`, every other family (dense, vlm, moe,
ssm, hybrid) to :mod:`.transformer`.  The serving engine, the train step
and the gang runtime go through these.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.common import cross_entropy
from repro_torch.models.params import ParamTree


def init_model(cfg: ModelConfig, generator: torch.Generator | None = None,
               device: str | torch.device = "cuda") -> ParamTree:
    """Random parameters drawn from ``generator`` (a seeded
    ``torch.Generator`` on ``device``; seed 0 when omitted)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator lies on {generator.device}, params are "
                         f"asked for on {dev}")
    if cfg.family == "encdec":
        return ParamTree(E.init_encdec(cfg, generator))
    return ParamTree(T.init_lm(cfg, generator))


def init_model_shapes(cfg: ModelConfig) -> ParamTree:
    """Every leaf of the model's :class:`ParamTree` as a ``meta`` tensor,
    under the reference's names and in ``cfg.param_dtype``: shapes and
    dtypes only, nothing allocated and nothing drawn (the counterpart of
    ``jax.eval_shape(lambda: init_model(cfg, key))``)."""
    if cfg.family == "encdec":
        return ParamTree(E.init_encdec(cfg, None))
    return ParamTree(T.init_lm(cfg, None))


def forward(
    cfg: ModelConfig,
    params,
    batch: dict,
    *,
    use_flash: bool = False,
    use_scan_kernel: bool = False,
    unembed_last_only: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward.  Returns (logits, aux_loss).  ``use_flash`` routes
    the causal attention of the dense, vlm and moe families and of the
    hybrid's shared block to kernel K2, ``use_scan_kernel`` the ssm
    family's WKV scan to kernel K3 and the hybrid's SSD scan to kernel K4
    (the reference's ``rwkv_time_mix(use_pallas=True)`` and
    ``ssd_block(use_pallas=True)`` routes, which its ``forward`` does not
    expose); both default to the reference's default route.  The encdec family takes neither: its
    attention is the plain route, as the reference's is."""
    if cfg.family == "encdec":
        return E.encdec_forward(cfg, params, batch,
                                unembed_last_only=unembed_last_only)
    return T.lm_forward(cfg, params, batch, use_flash=use_flash,
                        use_scan_kernel=use_scan_kernel,
                        unembed_last_only=unembed_last_only)


def loss_fn(
    cfg: ModelConfig,
    params,
    batch: dict,
    *,
    use_flash: bool = False,
    aux_weight: float = 0.01,
) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy plus ``aux_weight`` x the aux loss;
    returns ``(total, {"loss", "ce", "aux"})`` as the reference does.
    ``batch["labels"]`` is ``(b, s)`` integer."""
    logits, aux = forward(cfg, params, batch, use_flash=use_flash)
    labels = batch["labels"]
    # VLM: logits cover [patches, text]; loss only on the text positions.
    if cfg.family == "vlm":
        logits = logits[:, cfg.num_patches:]
    ce = cross_entropy(logits, labels)
    total = ce + aux_weight * aux
    return total, {"loss": total, "ce": ce, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: str | torch.device = "cuda") -> dict:
    if cfg.family == "encdec":
        return E.init_encdec_cache(cfg, batch, max_seq,
                                   resolve_device(device))
    return T.init_lm_cache(cfg, batch, max_seq, resolve_device(device))


def decode_step(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache: dict,
) -> tuple[torch.Tensor, dict]:
    if cfg.family == "encdec":
        return E.encdec_decode(cfg, params, tokens, positions, cache)
    return T.lm_decode(cfg, params, tokens, positions, cache)
