"""Build of the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries go into ``build/namazu_tpu_torch/`` at the
repository root, named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is reused. Sources come from
``csrc/`` only. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "namazu_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}
_lock = threading.Lock()


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("namazu_tpu_torch: nvcc not found (set CUDA_HOME)")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    one nvcc each, all started together. Returns seconds per kernel
    built (0.0 where the library already existed)."""
    names = list(kernel_names() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    seconds = {n: 0.0 for n in names}
    for n in names:
        out = lib_path(n)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[n] = (proc, out, tmp, time.perf_counter())
    failures = []
    for n, (proc, out, tmp, t0) in started.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        _logs[n] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {n}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output (with ptxas's register and memory report) from this
    process's build of ``name``, or "" if it was reused."""
    return _logs.get(name, "")


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib
