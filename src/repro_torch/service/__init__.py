"""Live scheduler service: async master-worker runtime with the
discrete-event :class:`~repro_torch.core.simulator.Simulator` as its
deterministic replay twin.

The package turns the offline reproduction into a long-running service
without forking the scheduling logic:

* :mod:`repro_torch.service.engine` — ``LiveEngine`` drives one ``Simulator``
  against wall-clock time (``virtual_now = v0 + (wall - w0) *
  time_scale``) and write-ahead journals every external stimulus;
* :mod:`repro_torch.service.journal` — the journal file *is* a repro-trace
  (jobs in the exact :mod:`repro_torch.scenarios.trace` schema, interleaved
  with ``{"event": ...}`` lines for advance barriers, scripted faults
  and epsilon retunes), so a recorded session replays bit-identically
  through the Simulator — the twin property every test asserts;
* :mod:`repro_torch.service.master` — asyncio master: line-JSON protocol,
  admission control, worker heartbeats/death/rejoin, checkpointing;
* :mod:`repro_torch.service.worker` — in-process worker agents plus the
  ``python -m repro_torch.service worker`` subprocess runner;
* :mod:`repro_torch.service.admission` — per-user queues, token-bucket rate
  limits, max-live-jobs backpressure;
* :mod:`repro_torch.service.telemetry` — live counters in the
  ``scenario_report`` vocabulary (sojourn/slowdown tails, Jain index,
  goodput, decision latency).

This is the PyTorch port of the JAX package's ``repro.service``: the
same modules and names, journals either package replays, and the
virtual clusters of the size-based disciplines on ``device`` ("cuda"
unless the caller asks for "cpu"; :mod:`repro_torch.service.engine`).
Its master differs from the JAX package's in three places, all listed in
:mod:`repro_torch.service.master`.  See docs/service.md for the
architecture and the determinism contract.
"""

from repro_torch.service.admission import AdmissionConfig, AdmissionControl
from repro_torch.service.engine import LiveEngine, live_fingerprint, replay_journal
from repro_torch.service.journal import Journal, read_journal
from repro_torch.service.master import Master, MasterConfig
from repro_torch.service.telemetry import Telemetry
from repro_torch.service.worker import WorkerAgent

__all__ = [
    "AdmissionConfig",
    "AdmissionControl",
    "Journal",
    "LiveEngine",
    "Master",
    "MasterConfig",
    "Telemetry",
    "WorkerAgent",
    "live_fingerprint",
    "read_journal",
    "replay_journal",
]
