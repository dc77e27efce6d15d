"""The benchmark's inputs, made from ``--seed`` on the device: the
streams of random numbers, the model's weights as one normal draw laid
out by the configuration's reference module (its ``make_weights``), and
Zipf-skewed token ids.

Both sides get the same inputs: the harness hands the weights to the port
(wrapped, not copied) and makes them again from the seed for the plain
reference once the program's state is freed.  Tokens follow the unigram
law p(i) ~ (i + 1)^-a over the real vocabulary (the synthetic LM
stream's skew), drawn by inverse CDF.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_TAGS = {"weights": 1, "tokens": 2, "order": 3, "sample": 4}


def sub_seed(seed: int, tag: str, *more: int) -> int:
    """A 63-bit seed for one stream of the run (weights, tokens, ...),
    derived from the run's seed, which may exceed 32 bits."""
    words = [seed & 0xFFFFFFFF, seed >> 32, _TAGS[tag], *more]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def generator(seed: int, tag: str, device, *more: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        sub_seed(seed, tag, *more))


def normal_tree(specs, seed: int, device, dtype: torch.dtype) -> dict:
    """Nested dicts of tensors in ``dtype``: one f32 normal draw from the
    seed covers every leaf of ``specs`` ((dotted path, shape, scale), in
    draw order); each leaf is a view of it, scaled in place."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    flat = torch.randn(total, generator=generator(seed, "weights", device),
                       device=device, dtype=torch.float32)
    tree: dict = {}
    off = 0
    for path, shape, scale in specs:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape).mul_(scale)
        off += n
        put(tree, path, leaf if dtype == torch.float32 else leaf.to(dtype))
    return tree


def put(tree: dict, path: str, leaf) -> None:
    *parents, name = path.split(".")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[name] = leaf


def leaves(tree: dict, prefix: str = "") -> dict:
    """{dotted path: tensor} of a nested dict (or a module's
    ``named_parameters``-like tree)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(leaves(v, path + "."))
        else:
            out[path] = v
    return out


def zipf_cdf(vocab: int, a: float, device) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = ranks ** (-a)
    return torch.cumsum(p / p.sum(), 0)


def zipf_tokens(cdf: torch.Tensor, shape, gen: torch.Generator
                ) -> torch.Tensor:
    """int64 token ids of ``shape`` drawn by inverse CDF from ``cdf``."""
    u = torch.rand(shape, generator=gen, device=cdf.device,
                   dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1)
