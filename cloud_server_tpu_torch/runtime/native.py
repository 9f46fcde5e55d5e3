"""ctypes bindings for the native C++ shard reader (csrc/data_loader.cpp).

A copy of the reference's `runtime/native.py`. The library is built on
demand with g++ the first time it is needed (about 2 s), into
`cloud_server_tpu_torch/_build/` (listed in .gitignore) under a name
that carries the hash of the source and flags, so an edited source is
rebuilt and an unchanged one reused. Without a compiler, or when the
build fails, `load_library()` returns None and callers read through the
numpy path of `cloud_server_tpu_torch.data` instead, which gives the
same batches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "data_loader.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libdata_loader_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.csr_open.restype = ctypes.c_void_p
    lib.csr_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
    lib.csr_num_windows.restype = ctypes.c_uint64
    lib.csr_num_windows.argtypes = [ctypes.c_void_p]
    lib.csr_read_windows.restype = ctypes.c_int
    lib.csr_read_windows.argtypes = [ctypes.c_void_p, u64p, ctypes.c_uint64,
                                     i32p]
    lib.csr_close.argtypes = [ctypes.c_void_p]
    lib.csr_prefetch_start.restype = ctypes.c_void_p
    lib.csr_prefetch_start.argtypes = [ctypes.c_void_p, u64p,
                                       ctypes.c_uint64, ctypes.c_uint64,
                                       ctypes.c_int, ctypes.c_int]
    lib.csr_prefetch_next.restype = ctypes.c_int
    lib.csr_prefetch_next.argtypes = [ctypes.c_void_p, i32p]
    lib.csr_prefetch_stop.argtypes = [ctypes.c_void_p]
    return lib


def load_library() -> ctypes.CDLL | None:
    """The native library, building it if needed; None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(out)))
        except OSError:
            _lib = None
        return _lib


def native_available() -> bool:
    return load_library() is not None


class NativeTokenDataset:
    """Drop-in for `data.dataset.MemmapTokenDataset` backed by the C++
    reader.

    Adds `read_batch` (gathered multi-window read in native code — the
    DataLoader's collate uses it when present) and `prefetch_batches`
    (fully native threaded read-ahead for index streams known up front).
    """

    def __init__(self, path: str | os.PathLike, seq_len: int,
                 dtype=np.uint16):
        lib = load_library()
        if lib is None:
            raise RuntimeError(
                "native runtime unavailable (no compiler / build failed); "
                "use cloud_server_tpu_torch.data.dataset.MemmapTokenDataset "
                "instead")
        self._lib = lib
        self.path = os.fspath(path)
        self.seq_len = seq_len
        dtype = np.dtype(dtype)
        if dtype.itemsize not in (2, 4):
            raise ValueError(f"unsupported token dtype {dtype}")
        self._h = lib.csr_open(self.path.encode(), seq_len, dtype.itemsize)
        if not self._h:
            raise ValueError(
                f"{self.path}: cannot open, or no full window of "
                f"seq_len={seq_len} fits")

    def __len__(self) -> int:
        return int(self._lib.csr_num_windows(self._h))

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        return {"tokens": self.read_batch(np.array([i]))["tokens"][0]}

    def read_batch(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        idx = np.ascontiguousarray(indices, np.uint64)
        out = np.empty((len(idx), self.seq_len), np.int32)
        rc = self._lib.csr_read_windows(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(idx), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc == -2:
            raise IndexError(f"window index out of range (have {len(self)})")
        if rc != 0:
            raise OSError(f"native read failed on {self.path} (rc={rc})")
        return {"tokens": out}

    def prefetch_batches(self, indices: np.ndarray, batch_size: int, *,
                         depth: int = 2, n_threads: int = 2
                         ) -> Iterator[dict[str, np.ndarray]]:
        """Yield (batch_size, seq_len) int32 batches for a fixed index
        stream, read ahead by native worker threads in submission order."""
        idx = np.ascontiguousarray(indices, np.uint64)
        ph = self._lib.csr_prefetch_start(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(idx), batch_size, depth, n_threads)
        if not ph:
            raise ValueError(
                "prefetch_start rejected arguments (empty stream, batch "
                "larger than stream, or out-of-range index)")
        try:
            while True:
                out = np.empty((batch_size, self.seq_len), np.int32)
                rc = self._lib.csr_prefetch_next(
                    ph, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
                if rc == 0:
                    return
                if rc < 0:
                    raise OSError(f"native prefetch read failed (rc={rc})")
                yield {"tokens": out}
        finally:
            self._lib.csr_prefetch_stop(ph)

    def close(self) -> None:
        if self._h:
            self._lib.csr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
