"""Build and load the port's CUDA C++ kernels (no counterpart in ``src/repro/``).

Each ``.cu`` source under ``src/repro_torch/csrc/`` is compiled on first use by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface and
loaded with :mod:`ctypes` (or started early by :func:`start`, all together,
and waited for at first use).  Libraries land in ``<repo>/build/repro_torch_kernels/``
(resolved from this file, not from the working directory), named by a hash
of the source and the shared headers so an edited kernel is rebuilt.  A
failed build raises.
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
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
BUILD_DIR = BUILD_ROOT / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")

_libs: Dict[str, ctypes.CDLL] = {}
_pending: Dict[str, tuple] = {}        # name -> (library path, nvcc) from start()
build_seconds: Dict[str, float] = {}   # nvcc wall time of each source built here
_sm_counts: Dict[int, int] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (PATH or CUDA_HOME)")


def library_path(name: str) -> Path:
    """Build path named by a hash of the source and the shared headers."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library is already built;
    returns (library path, process or None)."""
    out = library_path(name)
    if out.exists():
        return out, None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log").open("w")
    t0 = time.time()
    proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                             str(CSRC / f"{name}.cu")],
                            stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return out, (proc, tmp, t0)


def _finish(name: str, out: Path, pending) -> None:
    if pending is None:
        return
    proc, tmp, t0 = pending
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={rc}):\n"
                           + out.with_suffix(".log").read_text())
    build_seconds[name] = tmp.stat().st_mtime - t0    # the library's last write
    os.replace(tmp, out)


def start(names: Sequence[str]) -> None:
    """Start ``nvcc`` for every named source not built yet, all together,
    and return at once: :func:`load` waits for a source's build when it
    first needs the library (and raises if it failed)."""
    with _lock:
        for n in names:
            if n not in _libs and n not in _pending:
                out, pending = _start(n)
                if pending is not None:
                    _pending[n] = (out, pending)


def build(names: Sequence[str]) -> List[Path]:
    """Compile every named source in parallel (one ``nvcc`` each, all
    started together); returns the library paths and records each build's
    wall time in :data:`build_seconds`.  Raises on any failure."""
    started = [(n, *_start(n)) for n in names]
    errors = []
    for n, out, pending in started:      # wait for every nvcc, then raise
        try:
            _finish(n, out, pending)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    return [out for _, out, _ in started]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.
    Every library exports ``repro_error_string(int) -> const char*``.
    Loaded as a ``PyDLL``: a launcher only enqueues work and returns, so
    its calls keep the GIL rather than release and retake it."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if name in _pending:                 # started by start()
                _finish(name, *_pending.pop(name))
            [path] = build([name])
            lib = ctypes.PyDLL(str(path))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def build_log(name: str) -> str:
    """``nvcc -Xptxas=-v`` output of the last build (registers, shared
    memory, spills per kernel); empty when the library was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def stream(t: torch.Tensor) -> int:
    """Raw handle of the current CUDA stream of ``t``'s device for a C
    launcher: ``torch.cuda.current_stream(t.device).cuda_stream`` without
    building a ``Stream`` object on every launch."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def sm_count(dev: int) -> int:
    """Streaming multiprocessors of CUDA device ``dev``, queried once."""
    n = _sm_counts.get(dev)
    if n is None:
        n = _sm_counts[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C launcher (the
    launchers return ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({err})")
