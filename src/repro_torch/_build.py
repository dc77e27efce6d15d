"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Every kernel of the port is one ``csrc/<name>.cu`` file beside the module
that wraps it, listed in :data:`KERNELS` with the flags it needs beyond
the common ones; headers it includes sit beside it in ``csrc/``.  Each
exposes a plain C interface and is compiled on first use into
``build/repro_torch/lib<name>-<hash>.so`` at the root of the checkout
(git-ignored).  The file name carries a hash of the source, of the
headers beside it in its ``csrc/`` directory and of the flags, so an
edited source or header is rebuilt and never mixed up with a stale
library.  Nothing here
runs at import time: a machine without ``nvcc`` (the CPU test hosts) can
import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch import KernelError

PKG = Path(__file__).resolve().parent
BUILD_DIR = PKG.parents[1] / "build" / "repro_torch"

COMMON_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: kernel name -> (source, relative to the package; flags beyond
#: :data:`COMMON_FLAGS`).  The water-fill and the projection keep products
#: out of FMAs so they agree bitwise with their plain versions.
#: ``project_clocks`` is the projection with its per-phase cycle stamps
#: (for timing only; the main path runs ``project``).
KERNELS: dict[str, tuple[str, tuple[str, ...]]] = {
    "waterfill": ("accel/csrc/waterfill.cu", ("-fmad=false",)),
    "project": ("core/csrc/project.cu", ("-fmad=false",)),
    "project_clocks": ("core/csrc/project.cu",
                       ("-fmad=false", "-DPROJECT_PHASE_CLOCKS")),
    "flash_attention": ("kernels/flash_attention/csrc/flash_attention.cu", ()),
    "flash_attention_tc": (
        "kernels/flash_attention/csrc/flash_attention_tc.cu", ()),
    "rwkv6": ("kernels/rwkv6/csrc/rwkv6.cu", ()),
    "ssd": ("kernels/ssd/csrc/ssd.cu", ()),
}

#: name -> loaded library (one per source per process).
_LIBS: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build wall, "log": nvcc/ptxas output, "path": .so};
#: ``seconds`` is 0.0 when an up-to-date library was already on disk.
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise KernelError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin); the port's "
        "CUDA kernels are built from source at first use"
    )


def _source_and_flags(name: str) -> tuple[Path, tuple[str, ...]]:
    rel, extra = KERNELS[name]
    return PKG / rel, COMMON_FLAGS + extra


def lib_path(name: str) -> Path:
    """The library of kernel ``name``, named by a hash of its source, of
    the headers beside it in its ``csrc/`` directory (every file there but
    the ``.cu`` sources, each of which is a library of its own) and of its
    flags."""
    src, flags = _source_and_flags(name)
    h = hashlib.sha256(src.read_bytes())
    for dep in sorted(p for p in src.parent.iterdir()
                      if p.is_file() and p.suffix != ".cu"):
        h.update(dep.name.encode() + b"\0" + dep.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile kernel ``name`` unless an up-to-date library exists."""
    out = lib_path(name)
    if out.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "", "path": str(out)})
        return out
    src, flags = _source_and_flags(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(
            f"nvcc failed for {src.name} (rc {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    BUILD_INFO[name] = {
        "seconds": seconds, "log": proc.stdout + proc.stderr, "path": str(out),
    }
    return out


def build_all(names=tuple(KERNELS)) -> list[Path]:
    """Build the kernels ``names`` (by default every kernel of
    :data:`KERNELS`), one ``nvcc`` each, all started together."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib
