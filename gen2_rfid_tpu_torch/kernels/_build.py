"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface, ``build/gen2_rfid_tpu_torch/lib<name>-<hash>.so`` beside the
package, where the hash covers the source and the flags: an edited source
builds anew, an unchanged one is loaded as it is.  ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for them together.

Nothing here runs at import: the package imports on a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gen2_rfid_tpu_torch"
SOURCES = ("gate_front", "gate_stack", "gate_scan", "compat_gate", "gate_pulses", "probe")
# --fmad=false: no product is contracted into an FMA, so the kernels round as
# their plain PyTorch versions do.  Division and sqrt keep nvcc's IEEE
# defaults (-prec-div=true -prec-sqrt=true); no fast-math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
# ptxas's register / shared-memory report of each library built by this process.
build_logs: Dict[str, str] = {}
# Wall seconds of each library built by this process: from the start of its
# nvcc to when the build saw it end (0 libraries on a tree built before).
build_seconds: Dict[str, float] = {}


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every library in ``names`` that is not built yet, in parallel."""
    todo = [(n, library_path(n)) for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    t0 = time.perf_counter()
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib
