"""CLI: ``python -m repro_torch.service {master,worker,replay}``.

* ``master`` — boot (or crash-restore, if the journal already exists) a
  live master.  Prints ``LISTENING <port>`` on stdout once serving so
  wrappers can parse the ephemeral port; ``--port-file`` additionally
  writes it to a file (robust across a SIGKILL'd predecessor).
* ``worker`` — one worker agent for one machine.
* ``replay`` — run the deterministic twin over a recorded journal and
  print the completion fingerprint + summary (the offline half of the
  live-vs-twin assertion), with the JAX package's keys.

``master`` and ``replay`` take ``--device {cuda,cpu}`` (default cuda):
the virtual clusters of the size-based disciplines run there, on the
backend that ``$REPRO_VC_BACKEND`` picks.  Without the device, or on any
failure of the card or of a kernel of the port (at boot or in the
master's pacer), the command prints the error on stderr and exits 1;
``master`` then prints no ``LISTENING`` line.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from pathlib import Path

from repro_torch import is_device_failure
from repro_torch.core.types import ClusterSpec
from repro_torch.service.admission import AdmissionConfig
from repro_torch.service.engine import (
    LiveEngine,
    live_fingerprint,
    replay_journal,
)
from repro_torch.service.master import Master, MasterConfig
from repro_torch.service.worker import run_worker


def _master(args) -> int:
    if Path(args.journal).exists():
        engine = LiveEngine.restore(args.journal, time_scale=args.time_scale,
                                    device=args.device)
    else:
        cluster = ClusterSpec(
            num_machines=args.machines,
            map_slots_per_machine=args.map_slots,
            reduce_slots_per_machine=args.reduce_slots,
        )
        engine = LiveEngine.create(
            args.journal,
            args.policy,
            cluster,
            heartbeat=args.heartbeat,
            event_epsilon=args.eps,
            time_scale=args.time_scale,
            device=args.device,
        )
    cfg = MasterConfig(
        host=args.host,
        port=args.port,
        checkpoint_path=args.checkpoint,
        worker_dead_wall=args.worker_dead_wall,
        eps_auto_every_wall=args.eps_auto_every,
        admission=AdmissionConfig(
            max_live_jobs=args.max_live_jobs,
            rate_limit=args.rate_limit,
            burst=args.burst,
        ),
    )

    async def main() -> None:
        master = Master(engine, cfg)
        await master.start()
        print(f"LISTENING {master.port}", flush=True)
        if args.port_file:
            Path(args.port_file).write_text(str(master.port))
        await master.serve_forever()

    asyncio.run(main())
    return 0


def _worker(args) -> int:
    host, port = args.connect.rsplit(":", 1)
    asyncio.run(
        run_worker(
            host, int(port), args.machine, heartbeat_wall=args.heartbeat_wall
        )
    )
    return 0


def _replay(args) -> int:
    sim = replay_journal(args.journal, device=args.device)
    out = {
        "journal": str(args.journal),
        "completion_fingerprint": live_fingerprint(sim),
        "jobs_completed": len(sim.result.completion),
        "makespan_s": sim.result.makespan,
        "events": sim.events_processed,
        "passes": sim.passes,
    }
    print(json.dumps(out, sort_keys=True))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.service")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("master", help="run (or crash-restore) a live master")
    m.add_argument("--journal", required=True)
    m.add_argument("--checkpoint", default=None)
    m.add_argument("--policy", default="hfsp")
    m.add_argument("--machines", type=int, default=4)
    m.add_argument("--map-slots", type=int, default=4)
    m.add_argument("--reduce-slots", type=int, default=2)
    m.add_argument("--heartbeat", type=float, default=3.0)
    m.add_argument("--eps", default=0.0,
                   help="event_epsilon seconds, or 'auto'")
    m.add_argument("--eps-auto-every", type=float, default=0.25,
                   help="wall secs between auto-epsilon retunes (0 = off)")
    m.add_argument("--time-scale", type=float, default=1.0)
    m.add_argument("--host", default="127.0.0.1")
    m.add_argument("--port", type=int, default=0)
    m.add_argument("--port-file", default=None)
    m.add_argument("--worker-dead-wall", type=float, default=0.5)
    m.add_argument("--max-live-jobs", type=int, default=64)
    m.add_argument("--rate-limit", type=float, default=None)
    m.add_argument("--burst", type=int, default=8)
    m.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the virtual clusters run (default cuda)")
    m.set_defaults(fn=_master)

    w = sub.add_parser("worker", help="run one worker agent")
    w.add_argument("--connect", required=True, metavar="HOST:PORT")
    w.add_argument("--machine", type=int, required=True)
    w.add_argument("--heartbeat-wall", type=float, default=0.05)
    w.set_defaults(fn=_worker)

    r = sub.add_parser("replay", help="deterministic twin over a journal")
    r.add_argument("--journal", required=True)
    r.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the virtual clusters run (default cuda)")
    r.set_defaults(fn=_replay)

    args = p.parse_args(argv)
    if args.cmd == "master" and args.eps != "auto":
        args.eps = float(args.eps)
    try:
        return args.fn(args)
    except Exception as exc:
        if not is_device_failure(exc):
            raise
        print(f"repro_torch.service {args.cmd}: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
