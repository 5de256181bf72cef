"""Kernel dispatch, device choice and the CUDA build (port of
``repro.kernels.ops``).

- :func:`on_cuda` is the counterpart of ``on_tpu``.
- :func:`resolve_device` turns an entry point's ``device=`` argument into
  a ``torch.device``: ``None`` means ``cuda``, and asking for ``cuda``
  where no GPU is visible raises — nothing falls back to the CPU unless
  the caller asked for it.
- :func:`build_kernels` (called by :func:`load_library` on a miss) compiles the CUDA C++
  sources under ``csrc/`` with ``nvcc`` for ``sm_90a`` into shared
  libraries with a plain C interface, loaded with ``ctypes``.  Builds go
  to ``build/repro_torch/`` at the root of the checkout (listed in
  ``.gitignore``), one library per source, named by a hash of the source,
  the shared header and the flags — a changed source rebuilds, an
  unchanged one loads.  A lock guards the build and the load: the serving
  worker thread may build while other code builds too.
- :func:`tm_fused_votes` / :func:`tm_fused_predict`: fused TM inference
  through ``clause_votes`` (kernel K3 on CUDA tensors, its plain version
  on CPU tensors).

The paper-surface kernels K4, K5 and K6 have no entry here: callers use
their wrappers (``popcount.popcount_words``, ``pdl_race.pdl_race``,
``binary_matmul.binary_matmul``) and the ``ref`` oracles by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.core.popcount import argmax_tournament

from .clause_eval import clause_votes, make_vote_matrix

__all__ = ["on_cuda", "resolve_device", "load_library", "build_kernels",
           "launch", "KERNEL_SOURCES", "KERNEL_ARGTYPES", "tm_fused_votes",
           "tm_fused_predict", "make_vote_matrix"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# library name (also the name of its C launch function) -> source
KERNEL_SOURCES = {"swar_fused_votes": "swar_fused.cu",
                  "clause_votes": "clause_votes.cu",
                  "train_deltas": "train_deltas.cu",
                  "popcount_words": "popcount_words.cu",
                  "pdl_race": "pdl_race.cu",
                  "binary_matmul": "binary_matmul.cu"}
_HEADERS = ("tm_votes.cuh", "threefry.cuh")
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# each C launch function's arguments before the trailing (int device,
# void* stream): tensor pointers first, then the scalars
KERNEL_ARGTYPES = {
    "swar_fused_votes": (_P,) * 4 + (_I,) * 4,
    "clause_votes": (_P,) * 4 + (_I,) * 4,
    "train_deltas": (_P,) * 12 + (_I,) * 4 + (_U,) * 2,
    "popcount_words": (_P,) * 2 + (_I,) * 2,
    "pdl_race": (_P,) * 6 + (_I,) * 3 + (_F,),
    "binary_matmul": (_P,) * 3 + (_I,) * 3,
}

_lock = threading.RLock()      # load_library holds it around build_kernels
_libs: dict[str, ctypes.CDLL] = {}


def on_cuda() -> bool:
    """Whether a CUDA device is visible to torch."""
    return torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """``device=`` of an entry point → ``torch.device`` (``None`` → cuda).

    Raises ``RuntimeError`` for a cuda device when no GPU is visible:
    a run that asked for the card must not quietly run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not on_cuda():
        raise RuntimeError(
            f"device {str(dev)!r} requested (device=None means cuda) but "
            f"torch.cuda.is_available() is False; pass device='cpu' to "
            f"run on the CPU")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels need the CUDA toolkit to build")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (KERNEL_SOURCES[name], *_HEADERS):
        h.update((_CSRC / f).read_bytes())
    return _BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``nvcc`` for one source unless its library exists → the
    process, its temporary output and its final path."""
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
           str(_CSRC / KERNEL_SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {KERNEL_SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: other processes see all or none


def build_kernels() -> dict[str, Path]:
    """Build every kernel library that is not built yet, one ``nvcc``
    per source, all started together → {name: library path}."""
    with _lock:
        jobs = {name: _start_build(name) for name in KERNEL_SOURCES}
        try:
            for name, job in jobs.items():
                if job is not None:
                    _finish_build(name, job)
        finally:
            for job in jobs.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
        return {name: _lib_path(name) for name in KERNEL_SOURCES}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``; a miss builds every
    library that is not built yet (:func:`build_kernels`).

    Each library exports ``int <name>(...)`` — the arguments of
    ``KERNEL_ARGTYPES[name]``, then the device index and the stream; it
    returns a ``cudaError_t`` — and ``const char* <name>_error(int)``."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(build_kernels()[name]))
        fn = getattr(lib, name)
        fn.argtypes = [*KERNEL_ARGTYPES[name], _I, _P]
        fn.restype = _I
        err = getattr(lib, f"{name}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def launch(name: str, tensors: tuple[torch.Tensor, ...], ints: tuple
           ) -> None:
    """Call kernel ``name``'s C entry on ``tensors``' pointers and the
    scalars ``ints`` (Python ints, or floats where its signature takes
    a ``float``), on the current stream of their device; raise on a
    refused launch (``cudaGetLastError`` is checked right after it)."""
    argtypes = KERNEL_ARGTYPES[name]
    n_ptr = argtypes.count(_P)
    if len(tensors) != n_ptr or len(ints) != len(argtypes) - n_ptr:
        raise TypeError(f"kernel {name} takes {n_ptr} tensors and "
                        f"{len(argtypes) - n_ptr} scalars, got "
                        f"{len(tensors)} and {len(ints)}")
    lib = load_library(name)
    dev = tensors[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, name)(*(t.data_ptr() for t in tensors), *ints,
                            dev.index if dev.index is not None
                            else torch.cuda.current_device(), stream)
    if rc != 0:
        msg = getattr(lib, f"{name}_error")(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {rc} ({msg})")


def tm_fused_votes(literals: torch.Tensor, include: torch.Tensor,
                   vote_matrix: torch.Tensor) -> torch.Tensor:
    """Fused TM inference → (B, C) int32 class votes (the (B, C·M) clause
    matrix never reaches device memory on the kernel path)."""
    return clause_votes(literals, include, vote_matrix)


def tm_fused_predict(literals: torch.Tensor, include: torch.Tensor,
                     vote_matrix: torch.Tensor) -> torch.Tensor:
    """Votes + tournament argmax → (B,) predicted class."""
    return argmax_tournament(tm_fused_votes(literals, include, vote_matrix))

