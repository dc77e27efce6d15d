"""Whole-sweep-on-device subsystem (port of ``repro.accel``).

One simulation cell is a fixed-shape fluid step and a whole sweep matrix
(seeds × policies × error alphas) advances as one ``(B, J)`` batch on the
device:

* :mod:`repro_torch.accel.cell_step` — the fixed-shape fluid cell and its
  chunked driver;
* :mod:`repro_torch.accel.sweep_exec` — spec → packed cell batch →
  batched executor;
* :mod:`repro_torch.accel.waterfill` — the water-fill fixpoint as a CUDA
  kernel (``csrc/waterfill.cu``) beside its plain PyTorch version.

Tests hold each part against ``repro.accel`` on the same inputs.
"""

from repro_torch.accel.cell_step import (  # noqa: F401
    POLICY_CODES,
    init_state,
    params_from_numpy,
    run_packed,
)
from repro_torch.accel.sweep_exec import (  # noqa: F401
    accel_eligible,
    run_cells_accel,
    run_sweep_accel,
    synthesize_cell,
)
from repro_torch.accel.waterfill import (  # noqa: F401
    water_fill,
    water_fill_cuda,
    water_fill_pair,
    water_fill_pair_cuda,
    water_fill_pair_reference,
    water_fill_reference,
)
