"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled with nvcc for Hopper (`sm_90a`) into a
shared library with a plain C interface and loaded with ctypes. Libraries
go into `build/torch_kernels/` at the repository root, named by a hash of
the source, so a changed source is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported: the first call that launches a
kernel builds it. Sources that need building are compiled in parallel, one
nvcc process each.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass(frozen=True)
class Build:
    name: str
    path: Path
    seconds: float  # 0.0 when an earlier build of the same source was reused
    log: str        # nvcc's output, with the -Xptxas -v resource lines


_BUILDS: Dict[str, Build] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for candidate in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if candidate and (Path(candidate) / "bin" / "nvcc").exists():
            return str(Path(candidate) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, Build]:
    """Build the named kernels (those not built yet), all nvcc processes
    started together; raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        if name in _BUILDS:
            continue
        path = _library_path(name)
        if path.exists():
            log_path = path.with_suffix(".log")
            log = log_path.read_text() if log_path.exists() else ""
            _BUILDS[name] = Build(name, path, 0.0, log)
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started[name] = (proc, path, tmp, time.perf_counter())
    # wait for every nvcc before raising, so no compiler outlives the call
    logs = {name: (proc.communicate()[0], time.perf_counter() - t0)
            for name, (proc, _, _, t0) in started.items()}
    failed = [name for name, (proc, _, _, _) in started.items() if proc.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(f"nvcc failed for {name}.cu:\n{logs[name][0]}"
                                     for name in failed))
    for name, (_, path, tmp, _) in started.items():
        log, seconds = logs[name]
        os.replace(tmp, path)  # atomic: a concurrent process never loads a partial file
        path.with_suffix(".log").write_text(log)
        _BUILDS[name] = Build(name, path, seconds, log)
    return {name: _BUILDS[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)[name].path))
    return _LIBS[name]
