"""Native token data loader: counterpart of
``mpi_operator_tpu/native/dataloader.py`` over the same C++ source,
``native/tpudata.cpp``.

``NativeTokenLoader`` streams [batch, seq_len] int32 batches from a flat
binary token file with mmap and a background prefetch thread in C++, so
file IO overlaps the step.  Sharding follows the operator's process
contract: one seeded global shuffle per epoch (the same on every
process), process p consuming windows p, p+N, ... (disjoint and
exhaustive across the job).

The port builds its own copy of the library: ``g++ -O2 -std=c++17 -fPIC
-shared -lpthread`` (the flags of ``native/Makefile``) into
``build/torch_native/`` at the repository root (git-ignored), under a
name that carries a digest of the source and flags, so an edited source
is rebuilt and a stale library is never loaded.  A file lock serialises
the build across processes (ranks start together).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Optional

import numpy as np

# The operator's process contract (the env names it injects into every
# worker; mpi_operator_tpu/api/constants.py).
PROCESS_ID_ENV = "JAX_PROCESS_ID"
NUM_PROCESSES_ENV = "JAX_NUM_PROCESSES"

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "tpudata.cpp"
BUILD_DIR = _ROOT / "build" / "torch_native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtpudata-{digest[:16]}.so"


def build() -> Path:
    """Compile ``native/tpudata.cpp`` unless an up-to-date library
    exists; returns its path, raises on a failed build."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{SOURCE}:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.dl_open.restype = ctypes.c_void_p
            lib.dl_open.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.c_long, ctypes.c_ulong, ctypes.c_long]
            lib.dl_next.restype = ctypes.c_long
            lib.dl_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int32)]
            lib.dl_num_windows.restype = ctypes.c_long
            lib.dl_num_windows.argtypes = [ctypes.c_void_p]
            lib.dl_epoch.restype = ctypes.c_long
            lib.dl_epoch.argtypes = [ctypes.c_void_p]
            lib.dl_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def write_token_file(path: str, tokens) -> None:
    """Write a flat int32 little-endian token file (the loader's input
    format)."""
    arr = np.ascontiguousarray(np.asarray(tokens).reshape(-1),
                               dtype=np.int32)
    with open(path, "wb") as f:
        f.write(arr.tobytes())


class NativeTokenLoader:
    """Iterable over [batch, seq_len] int32 numpy batches.  The process
    id and count default to the operator's env (``JAX_PROCESS_ID``,
    ``JAX_NUM_PROCESSES``), else 0 of 1."""

    def __init__(self, path: str, seq_len: int, batch: int,
                 process_id: Optional[int] = None,
                 num_processes: Optional[int] = None,
                 seed: int = 0, prefetch_depth: int = 4):
        if process_id is None:
            process_id = int(os.environ.get(PROCESS_ID_ENV, "0"))
        if num_processes is None:
            num_processes = int(os.environ.get(NUM_PROCESSES_ENV, "1"))
        self._lib = _load()
        self.seq_len = seq_len
        self.batch = batch
        self._handle = self._lib.dl_open(
            path.encode(), seq_len, batch, process_id, num_processes,
            seed, prefetch_depth)
        if not self._handle:
            raise RuntimeError(f"tpudata: cannot open {path}")
        # Joins the producer thread and unmaps the file even if the
        # caller never calls close().
        self._finalizer = weakref.finalize(
            self, self._lib.dl_close, self._handle)

    def _live_handle(self):
        if not self._handle:
            raise RuntimeError("tpudata: loader is closed")
        return self._handle

    @property
    def num_windows(self) -> int:
        return int(self._lib.dl_num_windows(self._live_handle()))

    @property
    def epoch(self) -> int:
        """Epoch of the most recently consumed batch."""
        return int(self._lib.dl_epoch(self._live_handle()))

    def next_batch(self) -> np.ndarray:
        out = np.empty((self.batch, self.seq_len), dtype=np.int32)
        step = self._lib.dl_next(
            self._live_handle(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if step < 0:
            raise RuntimeError("tpudata: loader stopped")
        return out

    def __iter__(self):
        while True:
            yield self.next_batch()

    def close(self) -> None:
        if self._handle:
            self._finalizer.detach()
            self._lib.dl_close(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeTokenLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
