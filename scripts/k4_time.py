"""Time K4 (the Mamba2 SSD scan) on a CUDA card at zamba2-2.7b's prefill call.

    python3 scripts/k4_time.py                     # this checkout
    python3 scripts/k4_time.py --trees A B B A     # checkouts, in turns

Each tree is a checkout of this repository (its ``src/`` holds the port);
each run is a process of its own that builds that tree's kernels at first
use and times ``ssd_cuda`` on (b, h, t, p, n) = (4, 80, 4096, 64, 64),
chunk 64, with inputs as ``chip_smoke.py`` draws them (the model's decays
at its init, from ``--seed``): CUDA events over 20 calls after a warm-up,
in bf16 x/B/C and with the same values in f32, and each kernel's time
per launch in a profile of 5 calls.  Prints one JSON line per run, then
the card's name and power limit.  Compare trees only within one
invocation: two invocations may land on two cards.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(seed: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    bf16 = (x, dt, a, B, C, s0)
    f32 = (x.float(), dt, a, B.float(), C.float(), s0)

    def ms(args, reps=20):
        sk.ssd_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            sk.ssd_cuda(*args, chunk=chunk)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    got, _ = sk.ssd_cuda(*bf16, chunk=chunk)
    want, _ = sk.ssd_plain(*bf16, chunk=chunk)
    out = {"max_abs_err_bf16": (got.float() - want.float()).abs().max().item(),
           "ms_bf16": ms(bf16), "ms_f32_inputs": ms(f32)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            sk.ssd_cuda(*bf16, chunk=chunk)
        torch.cuda.synchronize()
    out["profiled_ms_per_launch"] = {
        (re.search(r"ssd_\w+", ev.key) or re.search(r".{0,40}", ev.key))[0]:
        ev.self_device_time_total / 1e3 / ev.count
        for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs="*", default=[str(ROOT)],
                        help="checkouts to time, one process each, in order")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        sys.path.insert(0, str(Path(args.child) / "src"))
        print(json.dumps(run(args.seed)), flush=True)
        return 0
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(Path(tree).resolve()),
             "--seed", str(args.seed)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, **result}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
