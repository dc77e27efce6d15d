"""Model parameters as a module, and the bridge from the reference's tree.

:class:`ParamTree` is an ``nn.Module`` that holds one model's parameters
under the reference's names, nested as the reference nests them
(``params["layers"]["attn"]["wq"]``, stacked ``(L, ...)`` layer axis
included), so its ``state_dict`` keys are the reference's paths joined by
dots.  The block functions read it like the reference's dict.  Its
parameters do not require grad unless asked: a serving tree stays
inference-only, and :func:`repro_torch.train.init_train_state` (and a
restore into a train state) turns gradients on.

:func:`tree_flatten` and :func:`tree_unflatten` walk a tree (a
:class:`ParamTree` or nested dicts) in ``jax.tree.flatten``'s order, dict
keys sorted at every level, so a leaf's index means the same leaf in both
packages (the optimizer and the checkpoint format rely on it).

:func:`from_reference` turns the reference's parameter tree, given as
nested dicts of numpy arrays, into a :class:`ParamTree` in
``cfg.param_dtype``, so the port and ``repro`` compute the same thing.
It walks any tree as it comes: every family's (the encdec family's
``encoder``/``decoder`` stacks and ``enc_pos``/``dec_pos``, the moe
family's ``layers.moe`` with its ``shared`` expert) or a subtree such
as one MoE layer's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


class ParamTree(nn.Module):
    """Nested parameters under the reference's names; reads like a dict."""

    def __init__(self, tree: dict, requires_grad: bool = False):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=requires_grad))
            else:
                self.add_module(name, ParamTree(leaf, requires_grad))

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

    def to_dict(self) -> dict:
        """The same leaves as nested dicts."""
        return {k: v.to_dict() if isinstance(v, ParamTree) else v
                for k, v in self.items()}


def as_dict(tree):
    """``tree`` as nested dicts: a ParamTree's :meth:`~ParamTree.to_dict`,
    nested dicts as they are."""
    return tree.to_dict() if isinstance(tree, ParamTree) else tree


def _children(tree) -> list:
    """(key, child) of a tree node in key order."""
    return sorted(tree.items(), key=lambda kv: kv[0])


def tree_flatten(tree) -> tuple[list[tuple[str, ...]], list]:
    """(paths, leaves) of a :class:`ParamTree` or nested dicts, in
    ``jax.tree.flatten``'s order (dict keys sorted at every level).  Any
    value that is not a dict or a ParamTree is a leaf."""
    paths, leaves = [], []
    _walk(tree, (), paths, leaves)
    return paths, leaves


def _walk(node, path, paths, leaves) -> None:
    # A module-level function, not a recursive closure: a closure that
    # calls itself is a reference cycle, which would keep every leaf it
    # saw (and the device memory under it) alive until the next garbage
    # collection.
    if isinstance(node, (dict, ParamTree)):
        for k, v in _children(node):
            _walk(v, (*path, k), paths, leaves)
    else:
        paths.append(path)
        leaves.append(node)


def tree_unflatten(like, leaves):
    """``leaves`` (in :func:`tree_flatten`'s order) in the structure of
    ``like``: a :class:`ParamTree` gives a ParamTree whose parameters
    require grad as ``like``'s do, nested dicts give nested dicts."""
    out = _build(like, iter(leaves))
    if isinstance(like, ParamTree):
        grad = any(p.requires_grad for p in like.parameters())
        return ParamTree(out, requires_grad=grad)
    return out


def _build(node, it):
    if isinstance(node, (dict, ParamTree)):
        return {k: _build(v, it) for k, v in _children(node)}
    return next(it)


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
