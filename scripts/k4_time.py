"""Time K4 (the Mamba2 SSD scan) on a CUDA card at zamba2-2.7b's prefill call.

    python3 scripts/k4_time.py                     # this checkout
    python3 scripts/k4_time.py --trees A B B A     # checkouts, in turns

Each tree is a checkout of this repository (its ``src/`` holds the port);
each run is a process of its own that builds that tree's kernels at first
use and times ``ssd_cuda`` on (b, h, t, p, n) = (4, 80, 4096, 64, 64),
chunk 64, with inputs as ``chip_smoke.py`` draws them (the model's decays
at its init, from ``--seed``): CUDA events over 20 calls after a warm-up,
in bf16 x/B/C and with the same values in f32, and each kernel's time
per launch in a profile of 5 calls (``kernel_time.py``).  Prints one JSON
line per run, then the card's name and power limit.  Compare trees only
within one invocation: two invocations may land on two cards.
"""

from __future__ import annotations

import functools
import sys

import kernel_time


def run(seed: int) -> dict:
    import torch

    from repro_torch.kernels.ssd import kernel as sk

    b, h, t, p, n, chunk = 4, 80, 4096, 64, 64, 64
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def seq(*tail):
        return torch.randn((b, t, h, *tail), generator=gen, device="cuda")

    x = seq(p).to(torch.bfloat16).transpose(1, 2)
    dt = torch.nn.functional.softplus(seq()).transpose(1, 2)
    a = torch.exp(-dt)
    B, C = (torch.randn((b, t, n), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    s0 = 0.1 * torch.randn((b, h, p, n), generator=gen, device="cuda")
    return kernel_time.measure(
        functools.partial(sk.ssd_cuda, chunk=chunk),
        functools.partial(sk.ssd_plain, chunk=chunk),
        (x, dt, a, B, C, s0), (x.float(), dt, a, B.float(), C.float(), s0),
        "ssd_")


if __name__ == "__main__":
    sys.exit(kernel_time.main(__doc__, __file__, run))
