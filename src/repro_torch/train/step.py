"""train_step / eval_step factories (the port's copy of
``repro/train/step.py``).

``make_train_step(cfg, opt_cfg)`` returns a pure ``(state, batch) ->
(state, metrics)`` function that runs eagerly (no ``torch.compile``):
the state it is given is left as it was, and a new one is returned.

* mixed precision: bf16 activations, fp32 master weights & Adam moments
  (the cast policy lives in the model layer);
* activation rematerialisation: each layer body is checkpointed
  (``remat="block"``, ``torch.utils.checkpoint``), the standard
  memory/compute trade for long-sequence training;
* gradient accumulation over microbatches, in f32; the metrics are the
  last microbatch's, as the reference's ``lax.scan`` leaves them;
* optional int8 gradient compression (``opt_cfg.grad_compression='int8'``):
  each grad is quantized and dequantized, as the reference does around
  its DP all-reduce.

The backward is autograd through the plain attention and the plain
scans.  The reference's kernels define no backward, and neither do the
port's (their wrappers refuse inputs that require grad), so
``TrainConfig(use_flash=True)`` is refused up front.  ``make_eval_step``
runs under ``torch.no_grad()`` and may take the flash kernel.

A state is ``{"params": ParamTree (grads on), "opt": {"m", "v", "step"}}``
on one device; batches are ``{"tokens", "labels"}`` int tensors there,
plus the family's ``patch_embeds`` (vlm) or ``frame_embeds`` (encdec),
which microbatching splits along with them.  The moe family's aux loss
enters the total with ``TrainConfig.aux_weight``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import init_model, init_model_shapes, loss_fn
from repro_torch.models.params import (
    ParamTree,
    as_dict,
    tree_flatten,
    tree_unflatten,
)
from repro_torch.train.optimizer import (
    OptimizerConfig,
    adamw_update,
    compress_int8,
    decompress_int8,
    init_opt_state,
)


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1          # gradient accumulation factor
    remat: str = "block"           # none | block
    use_flash: bool = False        # refused by make_train_step (no backward)
    aux_weight: float = 0.01       # MoE load-balance loss weight


def make_loss(cfg: ModelConfig, tc: TrainConfig):
    if tc.remat == "block" and not cfg.remat:
        cfg = dataclasses.replace(cfg, remat=True)

    def _loss(params, batch):
        return loss_fn(cfg, params, batch, use_flash=tc.use_flash,
                       aux_weight=tc.aux_weight)

    return _loss


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: OptimizerConfig,
    tc: TrainConfig | None = None,
):
    tc = tc or TrainConfig()
    if tc.use_flash:
        raise ValueError(
            "TrainConfig(use_flash=True): the flash attention kernel has no "
            "backward, nor has the reference's (it defines no custom_vjp), "
            "so a train step cannot take it; train with use_flash=False "
            "(autograd through the plain attention)")
    loss = make_loss(cfg, tc)

    def grad_of(params, batch) -> tuple[list, dict]:
        _, leaves = tree_flatten(params)
        if not all(p.requires_grad for p in leaves):
            raise ValueError("the params do not require grad: build the "
                             "state with init_train_state (or "
                             "train_state_to_device)")
        with torch.enable_grad():
            total, metrics = loss(params, batch)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params, opt_state = state["params"], state["opt"]
        if tc.microbatches > 1:
            mb = tc.microbatches
            micro = [{k: v[i * (v.shape[0] // mb):(i + 1) * (v.shape[0] // mb)]
                      for k, v in batch.items()} for i in range(mb)]
            acc = None
            for mbatch in micro:
                g, metrics = grad_of(params, mbatch)
                g = [x.float() for x in g]
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
            grads = [a / mb for a in acc]
        else:
            grads, metrics = grad_of(params, batch)

        if opt_cfg.grad_compression == "int8":
            grads = [decompress_int8(*compress_int8(g)) for g in grads]

        grads = tree_unflatten(as_dict(params), grads)
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, params, grads, opt_state
        )
        return {"params": params, "opt": opt_state}, {**metrics,
                                                       **opt_metrics}

    return train_step


def make_eval_step(cfg: ModelConfig, tc: TrainConfig | None = None):
    tc = tc or TrainConfig()
    loss = make_loss(cfg, tc)

    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = loss(params, batch)
        return metrics

    return eval_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator | None = None,
                     device: str | torch.device = "cuda") -> dict:
    """Random parameters (:func:`repro_torch.models.init_model`) with
    gradients on, and a zero optimizer state, on ``device``."""
    params = init_model(cfg, generator, device=device)
    params.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params)}


def init_train_state_shapes(cfg: ModelConfig) -> dict:
    """The train state of :func:`init_train_state` on ``meta``: params
    (grads on), ``m``, ``v`` and ``step`` with their shapes and dtypes and
    no storage (the counterpart of ``jax.eval_shape(init_train_state)``)."""
    params = init_model_shapes(cfg)
    params.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params)}


def train_state_to_device(tree: dict, device: str | torch.device = "cuda"
                          ) -> dict:
    """A train state read back by ``CheckpointStore.restore`` (nested dicts
    of numpy arrays) on ``device``, bitwise, its params a ParamTree with
    gradients on."""
    dev = resolve_device(device)
    return {"params": ParamTree(_to_device(tree["params"], dev),
                                requires_grad=True),
            "opt": _to_device(tree["opt"], dev)}


def _to_device(node, dev):
    if isinstance(node, dict):
        return {k: _to_device(v, dev) for k, v in node.items()}
    return torch.from_numpy(np.array(node)).to(dev)
