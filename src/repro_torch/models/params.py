"""Model parameters as a module, and the bridge from the reference's tree.

:class:`ParamTree` is an ``nn.Module`` that holds one model's parameters
under the reference's names, nested as the reference nests them
(``params["layers"]["attn"]["wq"]``, stacked ``(L, ...)`` layer axis
included), so its ``state_dict`` keys are the reference's paths joined by
dots.  The block functions read it like the reference's dict.  Parameters
do not require grad: the port serves and does not train yet.

:func:`from_reference` turns the reference's parameter tree, given as
nested dicts of numpy arrays, into a :class:`ParamTree` in
``cfg.param_dtype``, so the port and ``repro`` compute the same thing.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


class ParamTree(nn.Module):
    """Nested parameters under the reference's names; reads like a dict."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))
            else:
                self.add_module(name, ParamTree(leaf))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def __len__(self) -> int:
        return len(self._parameters) + len(self._modules)

    def items(self):
        yield from self._parameters.items()
        yield from self._modules.items()


def _leaf(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)  # exact; numpy has no bf16 torch can read
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def from_reference(cfg: ModelConfig, tree: dict,
                   device: str | torch.device = "cuda") -> ParamTree:
    """The reference's parameters (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, repro.models.init_model(cfg, key))``) as
    the port's :class:`ParamTree` on ``device``, in ``cfg.param_dtype``."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _leaf(node, dtype, dev)

    return ParamTree(convert(tree))
