"""The one generator of traffic: it reads a mix's parameters and gives the
shapes of its requests (prefill) or steps (train), in an order drawn
from the seed.

A prefill mix sets ``tokens_per_request`` and ``length_block``
({prompt length: count}); every request holds the same number of tokens,
b = tokens_per_request / L prompts of one length L, and each block of
requests holds every length its count of times, shuffled by the seed.  So
every seed sends the same set of sizes, in another order.  A train mix
sets ``batch`` and ``seq_len``: every step is one batch of that shape.
"""

from __future__ import annotations

import numpy as np

from portbench.inputs import sub_seed


def prefill_shapes(traffic: dict, seed: int, n: int) -> list[tuple[int, int]]:
    """(b, L) of the first ``n`` requests."""
    total = traffic["tokens_per_request"]
    block = []
    for length, count in traffic["length_block"].items():
        length = int(length)
        if total % length:
            raise ValueError(f"{total} tokens are no whole number of prompts "
                             f"of length {length}")
        block += [length] * int(count)
    rng = np.random.default_rng(sub_seed(seed, "order"))
    out = []
    while len(out) < n:
        for length in rng.permutation(block):
            out.append((total // int(length), int(length)))
    return out[:n]


def lengths(traffic: dict) -> list[int]:
    """The prompt lengths of a prefill mix, ascending."""
    return sorted(int(k) for k in traffic["length_block"])
