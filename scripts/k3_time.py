"""Time K3 (the RWKV6 WKV scan) on a CUDA card at rwkv6-1.6b's prefill call.

    python3 scripts/k3_time.py                     # this checkout
    python3 scripts/k3_time.py --trees A B B A     # checkouts, in turns

Each tree is a checkout of this repository (its ``src/`` holds the port);
each run is a process of its own that builds that tree's kernels at first
use and times ``rwkv6_cuda`` on (b, h, t, d) = (4, 32, 4096, 64), chunk
64, with inputs as ``chip_smoke.py``'s K3 timing draws them (decay
sharpness 2.0, from ``--seed``): CUDA events over 20 calls after a
warm-up, in bf16 r/k/v and with the same values in f32, and each
kernel's time per launch in a profile of 5 calls (``kernel_time.py``).
Prints one JSON line per run, then the card's name and power limit.
Compare trees only within one invocation: two invocations may land on
two cards.
"""

from __future__ import annotations

import functools
import sys

import kernel_time


def run(seed: int) -> dict:
    import torch

    from repro_torch.kernels.rwkv6 import kernel as rk

    b, h, t, d, chunk = 4, 32, 4096, 64, 64
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def seq():
        return torch.randn((b, t, h, d), generator=gen, device="cuda")

    r, k, v = (seq().to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    w = torch.exp(-torch.exp(seq() - 2.0)).transpose(1, 2)
    u = 0.1 * torch.randn((h, d), generator=gen, device="cuda")
    s0 = 0.1 * torch.randn((b, h, d, d), generator=gen, device="cuda")
    return kernel_time.measure(
        functools.partial(rk.rwkv6_cuda, chunk=chunk),
        functools.partial(rk.rwkv6_plain, chunk=chunk),
        (r, k, v, w, u, s0), (r.float(), k.float(), v.float(), w, u, s0),
        "rwkv6_")


if __name__ == "__main__":
    sys.exit(kernel_time.main(__doc__, __file__, run))
