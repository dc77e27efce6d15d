"""Readings the limits of ``cells/<cell>.json`` are set from: the numbers
of a cell's comparison over many seeds in one process, with the program
(the lower readings), the control or a fault in its place (the upper
ones).  The benchmark's own runs never run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 6 --stand-in program [--out chiprun_out/x.jsonl]

``--stand-in`` is ``program``, ``control`` or a fault of the cell's loop
(``FAULTS`` of ``kinds/<kind>.py``).  Each seed prints one JSON line with its
numbers, the requests or steps of its window and its seconds.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:1] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None, *, root: Path = ROOT, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--stand-in", default="program")
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    from portbench import cellspec, counting, loops

    cell = cellspec.find_cell(root, args.workload)
    device = torch.device(device or "cuda")
    card = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            run = loops.Run(kind=cell.traffic["kind"], model=cell.model,
                            traffic=cell.traffic, seed=seed, device=device,
                            t0=t, ref=cell.reference, window_s=args.seconds,
                            peaks=counting.peaks(card))
            if args.stand_in == "control" and \
                    hasattr(cell.kind, "control_numbers"):
                numbers = cell.kind.control_numbers(run)
            else:
                cell.kind.run(run, {}, loops.hooks(cell.kind, args.stand_in,
                                                   run))
                numbers = run.numbers
            line = json.dumps({"cell": cell.name, "stand_in": args.stand_in,
                               "seed": seed, "numbers": numbers,
                               "notes": run.notes,
                               "items": len(run.items),
                               "setup_s": run.setup_s,
                               "phases": run.phases,
                               "seconds": time.perf_counter() - t,
                               "card": card})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            del run
            loops.free(device)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
