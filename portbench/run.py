"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (the program under ``src/``).  The cell, its
configuration, traffic mix, limits and metric readers are found by the
names in ``BENCHMARK.json``.  Without a CUDA device, or with fewer than
the cell asks for, it exits 1 and prints no result.  The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each compared number beside its limit, which are
also the last lines of standard error).
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

from portbench import cellspec  # noqa: E402

#: Top-level module names the process must not hold once the window has
#: closed: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None, *, root: Path = ROOT, device=None,
         stand_in: str = "program", t0: float = T0) -> int:
    """Run the cell; 0 with a result line, non-zero without one.
    ``device`` and ``stand_in`` (the control or a fault of the cell's
    loop, under the window) are for tests: a device other than the card
    skips the look for one."""
    args = parse(argv)
    try:
        cell = cellspec.find_cell(root, args.workload)
        entries = cell.per_layer if args.trace else cell.end_to_end
        readers = {m["name"]: cellspec.load_reader(root, m["name"])
                   for m in entries}
    except cellspec.SpecError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2

    import torch

    from portbench import checks, counting, loops, tracing

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            print(f"portbench: {cell.name} needs {cell.chips} CUDA "
                  f"device(s), this process sees {have}", file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
    device = torch.device(device)
    card = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    run = loops.Run(kind=cell.traffic["kind"], model=cell.model,
                    traffic=cell.traffic, seed=args.seed, device=device,
                    t0=t0, ref=cell.reference, trace=bool(args.trace),
                    window_s=args.seconds, peaks=counting.peaks(card))
    spans = {}
    for reader in readers.values():
        spans.update(getattr(reader, "SPANS", {}))
    cell.kind.run(run, spans, loops.hooks(cell.kind, stand_in, run))

    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found} after the window",
              file=sys.stderr)
        return 3
    correct, judged = checks.judge(run.numbers, cell.limits)
    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif not args.trace:
            print(f"portbench: no reading of {m['name']}", file=sys.stderr)
            return 4
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": card, "count": cell.chips,
           "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": correct, "attempted": len(run.items), "failed": 0,
              "metrics": metrics, "device": dev}
    if run.traced is not None:
        dev["busy_s"] = run.traced.busy_s
        dev["window_s"] = run.traced.window_s
        result["breakdown"] = tracing.breakdown(run.traced)
        print(f"portbench: idle gaps with no launch found: "
              f"{run.traced.unattributed}; host calls in the window: "
              f"{json.dumps(tracing.largest(run.traced.host_calls))}",
              file=sys.stderr)
    print(f"portbench: phases {json.dumps(run.phases)}", file=sys.stderr)
    for name, value in run.notes.items():
        print(f"portbench: {name} {value!r}", file=sys.stderr)
    for name, value in run.numbers.items():
        if name not in judged:
            print(f"portbench: {name} {value!r} (not compared)",
                  file=sys.stderr)
    for name, v in judged.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    result["checks"] = judged
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
