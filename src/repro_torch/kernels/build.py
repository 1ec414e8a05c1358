"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` compiles, from the sources in the checkout only,
into a shared library with a plain C interface under
``build/repro_torch/`` at the repository root, named by a hash of its
source, of every ``csrc/*.cuh`` header and of the flags: a changed
source or header builds anew, an unchanged one loads what is there.
:func:`build` starts one ``nvcc`` per source, all
together, and waits for them; :func:`load` returns the loaded library.
Nothing builds when the module is imported, so the CPU tests import it
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BuildResult", "build", "load", "sources"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# -Xptxas -v reports each kernel's registers, shared memory and spills
# into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_BUILD_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class BuildResult:
    """One kernel library: where it is, whether this call compiled it,
    how long that took, and what ``nvcc`` printed."""

    name: str
    path: Path
    compiled: bool
    seconds: float
    log: str


def sources() -> tuple[str, ...]:
    """The kernel names: one per ``csrc/*.cu``."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise ValueError(f"no kernel source {src.name}; have {sources()}")
    h = hashlib.sha256(src.read_bytes())
    # every header too, so that an edited one rebuilds the sources that
    # may include it
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] | None = None) -> dict[str, BuildResult]:
    """Compile every named kernel (default: all) that is not built yet,
    one ``nvcc`` each, all started together.  Raises with ``nvcc``'s
    output if any build fails."""
    names = sources() if names is None else tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, running = {}, {}
    for name in names:
        path = _library_path(name)
        if path.exists():
            log_path = path.with_suffix(".log")
            log = log_path.read_text() if log_path.exists() else ""
            results[name] = BuildResult(name, path, False, 0.0, log)
            continue
        # compile into a private file and rename it into place, so a
        # concurrent loader never sees a partial library
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, path, tmp, time.perf_counter())
    failures = []
    try:
        for name, (proc, path, tmp, t0) in running.items():
            log, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {name}.cu "
                                f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, path)
            path.with_suffix(".log").write_text(log)
            results[name] = BuildResult(name, path, True, seconds, log)
    finally:
        for proc, _, tmp, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


_LOADED: dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name].path))
        _LOADED[name] = lib
    return lib
