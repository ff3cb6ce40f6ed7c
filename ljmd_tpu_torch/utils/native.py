"""ctypes loader of the port's native C++ runtime library (counterpart of
``ljmd_tpu/utils/native.py``; source ``ljmd_tpu_torch/native/ljmd_native.cpp``).

Bulk ran3 generation, rva.dat trajectory IO and the asynchronous rva.dat
appender (a worker thread drains a frame queue, so trajectory IO overlaps
the card's compute). The library is built at first use with the host's C++
compiler (``$CXX``, else ``c++`` / ``g++``) into
``build/ljmd_tpu_torch/native/<source hash>/`` under the checkout, as
``ops/_cuda.py`` builds the kernels; nothing is built when the module is
imported. Every entry point but the async writer has a pure-Python fallback
(``utils/ran3.py``, ``io/fortran_records.py``) for when no compiler is
there; the async writer's is ``io/trajectory.TrajectoryWriter``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["load", "ensure_built", "available", "library_path", "ran3_fill",
           "write_rva_native", "read_rva_native", "async_writer_open", "async_writer_append",
           "async_writer_sync", "async_writer_close"]

SOURCE = Path(__file__).resolve().parents[1] / "native" / "ljmd_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ljmd_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")
LIB_NAME = "libljmd_native.so"

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_lock = threading.Lock()


def _compiler() -> Optional[str]:
    for c in (os.environ.get("CXX"), "c++", "g++"):
        if c and shutil.which(c):
            return shutil.which(c)
    return None


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def ensure_built() -> bool:
    """Compile the library if this source hash is not built yet (into a
    temporary file, then an atomic rename, so concurrent builders never see
    half a library). Returns True when the library exists."""
    lib = library_path()
    if lib.exists():
        return True
    cxx = _compiler()
    if cxx is None:
        return False
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            return False
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return True


def load() -> Optional[ctypes.CDLL]:
    """The loaded library with its argtypes declared, or None when it cannot
    be built or loaded."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(library_path())) if ensure_built() else None
        except OSError:
            lib = None
        if lib is None:
            _load_failed = True
            return None
        dbl_arr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
        lib.ljmd_ran3_fill.argtypes = [ctypes.c_int64, dbl_arr, ctypes.c_int64]
        lib.ljmd_ran3_fill.restype = ctypes.c_int
        lib.ljmd_write_rva.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32, dbl_arr, dbl_arr, dbl_arr, dbl_arr,
        ]
        lib.ljmd_write_rva.restype = ctypes.c_int
        lib.ljmd_read_rva_header.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ljmd_read_rva_header.restype = ctypes.c_int
        lib.ljmd_read_rva_frames.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64,
            dbl_arr, dbl_arr, dbl_arr, dbl_arr,
        ]
        lib.ljmd_read_rva_frames.restype = ctypes.c_int
        lib.ljmd_rva_async_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ]
        lib.ljmd_rva_async_open.restype = ctypes.c_void_p
        lib.ljmd_rva_async_append.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, dbl_arr, dbl_arr, dbl_arr, dbl_arr,
        ]
        lib.ljmd_rva_async_append.restype = ctypes.c_int
        for name in ("close", "sync"):
            fn = getattr(lib, f"ljmd_rva_async_{name}")
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.ljmd_rva_async_frames.argtypes = [ctypes.c_void_p]
        lib.ljmd_rva_async_frames.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def ran3_fill(seed: int, n: int) -> np.ndarray:
    """Bulk uniform stream; bit-identical to utils.ran3.Ran3(seed)."""
    lib = load()
    if lib is None:
        from ljmd_tpu_torch.utils.ran3 import Ran3

        return Ran3(seed).uniform(n)
    out = np.empty(n, dtype=np.float64)
    rc = lib.ljmd_ran3_fill(seed, out, n)
    if rc != 0:
        raise RuntimeError(f"ljmd_ran3_fill failed: {rc}")
    return out


def write_rva_native(path, box_length, dt, output_interval, r, ru, v, a) -> None:
    """Native rva.dat writer; falls back to the Python codec."""
    lib = load()
    arrs = [np.ascontiguousarray(x, dtype=np.float64) for x in (r, ru, v, a)]
    if lib is None:
        from ljmd_tpu_torch.io.fortran_records import write_rva

        write_rva(path, box_length, dt, output_interval, *arrs)
        return
    n_frames, n = arrs[0].shape[0], arrs[0].shape[1]
    rc = lib.ljmd_write_rva(path.encode(), n, float(box_length), float(dt),
                            int(output_interval), n_frames, *arrs)
    if rc != 0:
        raise RuntimeError(f"ljmd_write_rva failed: {rc}")


def read_rva_native(path: str):
    """Native rva.dat reader; falls back to the Python codec (no library,
    8-byte markers). Returns the same RVAData."""
    from ljmd_tpu_torch.io.fortran_records import RVAData, read_rva

    lib = load()
    if lib is None:
        return read_rva(path)
    n = ctypes.c_int32()
    L = ctypes.c_double()
    dt = ctypes.c_double()
    interval = ctypes.c_int32()
    n_hdr = ctypes.c_int32()
    n_actual = ctypes.c_int64()
    rc = lib.ljmd_read_rva_header(
        path.encode(), ctypes.byref(n), ctypes.byref(L), ctypes.byref(dt),
        ctypes.byref(interval), ctypes.byref(n_hdr), ctypes.byref(n_actual),
    )
    if rc != 0:
        return read_rva(path)
    n_frames = int(n_actual.value)
    shape = (n_frames, int(n.value), 3)
    r, ru, v, a = (np.empty(shape) for _ in range(4))
    rc = lib.ljmd_read_rva_frames(path.encode(), n.value, n_frames, r, ru, v, a)
    if rc != 0:
        return read_rva(path)
    return RVAData(n=int(n.value), box_length=L.value, dt=dt.value,
                   output_interval=int(interval.value), n_snapshots=n_frames,
                   r=r, ru=ru, v=v, a=a)


def async_writer_open(path: str, n: int, box_length: float, dt: float, output_interval: int,
                      n_expected: int, append: bool = False, frames_present: int = 0):
    """Open the native asynchronous rva.dat appender. Returns an opaque
    handle, or None when the library is unavailable or the file cannot be
    opened."""
    lib = load()
    if lib is None:
        return None
    handle = lib.ljmd_rva_async_open(path.encode(), n, float(box_length), float(dt),
                                     int(output_interval), int(n_expected),
                                     1 if append else 0, int(frames_present))
    return handle or None


def async_writer_append(handle, r, ru, v, a) -> None:
    """Enqueue frames ((n_frames, N, 3) or (N, 3) each) and return."""
    arrs = [np.ascontiguousarray(x, dtype=np.float64) for x in (r, ru, v, a)]
    if arrs[0].ndim == 2:
        arrs = [x[None] for x in arrs]
    rc = load().ljmd_rva_async_append(handle, arrs[0].shape[0], *arrs)
    if rc != 0:
        raise RuntimeError(f"ljmd_rva_async_append failed: {rc}")


def async_writer_sync(handle) -> None:
    """Crash-consistency fence: block until every enqueued frame is on disk
    (drain + fflush + fsync). The streaming driver calls it before each
    checkpoint, so a checkpoint never claims more frames than rva.dat
    holds."""
    rc = load().ljmd_rva_async_sync(handle)
    if rc != 0:
        raise RuntimeError(f"ljmd_rva_async_sync failed: {rc}")


def async_writer_close(handle) -> None:
    """Drain, patch the header with the frame count, close, free."""
    rc = load().ljmd_rva_async_close(handle)
    if rc != 0:
        raise RuntimeError(f"ljmd_rva_async_close failed: {rc}")
