"""Measure f64 instruction latencies on a CUDA card, in cycles (clock64).

    python3 scripts/f64_latency.py

Builds a small probe with ``nvcc`` (the projection kernel's flags:
``sm_90a``, ``-O3``, ``-fmad=false``) into ``build/f64_latency/`` and runs
one warp of it.  Each probe times a loop of 256 steps and prints cycles
per step:

* ``dadd``, ``dmul``: one dependent f64 add or multiply a step;
* ``ddiv``: one dependent correctly rounded f64 division a step;
* ``ddiv_x8``: eight independent divisions a step (one chain each);
* ``checked_x8``: eight independent divisions a step by the projection
  kernel's ``div_checked`` (its source is read from
  ``src/repro_torch/core/csrc/project.cu``), each with its check;
* ``rcp_x8``: eight independent ``rcp.approx.ftz.f64`` a step;
* ``select_x8``: eight lanes of ``r = fmax(r - a * d, 0.0)`` guarded by
  a per-lane flag, as the projection's commit writes it;
* ``shfl``: one dependent f64 ``__shfl_xor_sync`` and add a step;
* ``redux``: one dependent ``__reduce_min_sync`` a step.

Prints one JSON line, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "f64_latency"
STEPS = 256

SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>
#define STEPS_N 256
%(helpers)s
__global__ void probe(double* io, long long* cyc) {
  const int tid = threadIdx.x;
  double x = io[tid], y = io[32 + tid];
  double v[8];
  for (int j = 0; j < 8; ++j) v[j] = io[64 + 8 * tid + j];
  unsigned flags = static_cast<unsigned>(io[320 + tid]);
  long long t0, t1;
  // dadd
  t0 = clock64();
  for (int i = 0; i < STEPS_N; ++i) x = x + y;
  t1 = clock64(); cyc[0] = t1 - t0;
  // dmul
  t0 = clock64();
  for (int i = 0; i < STEPS_N; ++i) x = x * y;
  t1 = clock64(); cyc[1] = t1 - t0;
  // ddiv
  t0 = clock64();
  for (int i = 0; i < STEPS_N; ++i) x = y / x;
  t1 = clock64(); cyc[2] = t1 - t0;
  // ddiv_x8
  t0 = clock64();
  for (int i = 0; i < STEPS_N; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = y / v[j];
  }
  t1 = clock64(); cyc[3] = t1 - t0;
  // checked_x8
  unsigned okm = 0u;
  t0 = clock64();
  for (int i = 0; i < STEPS_N; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bool ok;
      v[j] = div_checked(y, v[j], ok);
      okm |= static_cast<unsigned>(ok) << j;
    }
  }
  t1 = clock64(); cyc[7] = t1 - t0;
  // rcp_x8
  t0 = clock64();
  for (int i = 0; i < STEPS_N; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = rcp_approx(v[j]) + 1.0;
  }
  t1 = clock64(); cyc[8] = t1 - t0;
  flags ^= okm;
  // select_x8
  t0 = clock64();
  for (int i = 0; i < STEPS_N; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if ((flags >> j) & 1u) v[j] = fmax(v[j] - y * x, 0.0);
    x = x + v[i & 7];
  }
  t1 = clock64(); cyc[4] = t1 - t0;
  // shfl
  t0 = clock64();
  for (int i = 0; i < STEPS_N; ++i) x = x + __shfl_xor_sync(0xffffffffu, x, 1 + (i & 15));
  t1 = clock64(); cyc[5] = t1 - t0;
  // redux
  unsigned u = static_cast<unsigned>(tid);
  t0 = clock64();
  for (int i = 0; i < STEPS_N; ++i) u = __reduce_min_sync(0xffffffffu, u + tid) + 1u;
  t1 = clock64(); cyc[6] = t1 - t0;
  double s = x + static_cast<double>(u);
  for (int j = 0; j < 8; ++j) s += v[j];
  io[tid] = s;
}
extern "C" int run(double* io, long long* cyc) {
  probe<<<1, 32>>>(io, cyc);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""

NAMES = ("dadd", "dmul", "ddiv", "ddiv_x8", "select_x8", "shfl", "redux",
         "checked_x8", "rcp_x8")


def helpers() -> str:
    """``rcp_approx``, ``in_range`` and ``div_checked`` as the projection
    kernel defines them."""
    src = (ROOT / "src/repro_torch/core/csrc/project.cu").read_text()
    start = src.index("// A fast approximation of 1 / b")
    end = src.index("// The event times r / al of a thread's K lanes")
    return src[start:end]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("f64_latency: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "probe.cu", OUT / "libprobe.so"
    src.write_text(SOURCE % {"helpers": helpers()})
    subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-fmad=false", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    run = ctypes.CDLL(str(lib)).run
    run.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    gen = torch.Generator().manual_seed(0)
    io = (1.0 + torch.rand(352, generator=gen, dtype=torch.float64)).cuda()
    io[320:352] = 0xA5  # flags: every other lane of the eight
    cyc = torch.zeros(len(NAMES), dtype=torch.int64, device="cuda")
    for _ in range(2):  # the second run is timed warm
        if run(io.data_ptr(), cyc.data_ptr()) != 0:
            raise RuntimeError("probe failed")
    print(json.dumps({n: c / STEPS for n, c in zip(NAMES, cyc.tolist())}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
