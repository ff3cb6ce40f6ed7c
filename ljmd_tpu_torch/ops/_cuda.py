"""Build and load the hand-written CUDA kernels (``ljmd_tpu_torch/csrc``).

The kernels are compiled by ``nvcc`` into one shared library with a plain C
interface and loaded with ``ctypes``: no PyTorch headers, so a build takes
seconds. The library goes to ``build/ljmd_tpu_torch/<hash>/`` under the
checkout, keyed by a hash of the sources and the flags, and is built at first
use. Nothing here runs when the module is imported, and nothing needs ``nvcc``
until a kernel is launched on a CUDA tensor.

Each source is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into the library with ``-shared``.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3`` (Hopper), never
``--use_fast_math`` (it would break the Neumaier two-sums and the IEEE divide
of the pair terms).

Every wrapper counts its launches in ``LAUNCHES`` so that a run can show that
the main path went through the kernels; the replica launches of kernels 2,
3, 4, 6, 7, 9, 10 and 11-16 (one launch for the R replicas of an ensemble, or a
rank's replicas in the replica x particle step) count under their own names
(``*_replicas``). The cell-pair rebin's two launches count as ``rebin_keys``
and ``rebin_gather`` (``*_replicas`` for a replica stack), the zsort resort's
as ``zsort_sort`` and ``zsort_pack`` (``*_replicas`` for a stack; the sort's
global-memory path also as ``zsort_sort_global``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from ljmd_tpu_torch.utils.profiling import counter

__all__ = ["LAUNCHES", "build", "library", "check", "stream_handle"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ljmd_tpu_torch"
SOURCES = ("pair_sweep_tri.cu", "pair_sweep.cu", "fused_dense_chunk.cu", "pack_window_lists.cu",
           "fused_dense_chunk_list.cu", "pencil_sweep_hs.cu", "fused_pencil_chunk.cu",
           "fused_pencil_width_chunk.cu", "pencil_sweep_full.cu", "pencil_sweep_zband.cu",
           "pair_sweep_rect.cu", "mosaic_probes.cu", "layout_bodies.cu", "pencil_rebin.cu",
           "zsort_resort.cu")
HEADERS = ("lj_pair_terms.cuh", "rows_sweep.cuh", "pencil_pairs.cuh",
           "async_copy.cuh", "pencil_cull.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
LIB_NAME = "libljmd_kernels.so"


class LaunchCounts:
    """Plain integer launch counters, one per kernel wrapper."""

    NAMES = ("lj_pair_terms", "pair_sweep_tri", "pair_sweep", "fused_dense_chunk",
             "fused_dense_chunk_ext", "fused_dense_chunk_flags", "build_window_lists",
             "fused_dense_chunk_list", "pencil_sweep_hs", "fused_pencil_chunk", "fused_pencil_width_chunk",
             "pencil_sweep_full", "pencil_sweep_zband", "pair_sweep_rect",
             "pair_sweep_rect_newton", "mosaic_probes", "layout_bodies",
             "pair_sweep_tri_replicas", "fused_dense_chunk_replicas",
             "fused_dense_chunk_ext_replicas", "pair_sweep_rect_replicas",
             "pair_sweep_rect_newton_replicas", "build_window_lists_replicas",
             "fused_dense_chunk_list_replicas", "pencil_sweep_hs_replicas",
             "fused_pencil_chunk_replicas", "fused_pencil_width_chunk_replicas",
             "pencil_sweep_full_replicas", "pencil_sweep_zband_replicas",
             "rebin_keys", "rebin_gather", "rebin_keys_replicas", "rebin_gather_replicas",
             "zsort_sort", "zsort_sort_replicas", "zsort_sort_global", "zsort_pack",
             "zsort_pack_replicas")

    def __init__(self) -> None:
        self.counts = dict.fromkeys(self.NAMES, 0)
        self._lock = threading.Lock()  # the ranks of a thread mesh launch at once

    def bump(self, name: str) -> None:
        with self._lock:
            self.counts[name] += 1

    def reset(self) -> None:
        self.counts = dict.fromkeys(self.NAMES, 0)

    def snapshot(self) -> dict:
        return dict(self.counts)


LAUNCHES = counter(LaunchCounts())


def _nvcc() -> str:
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels are built from ljmd_tpu_torch/csrc at first use"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if this source hash is not built yet) and return
    the library path. ``verbose`` adds ``-Xptxas -v`` and prints nvcc's
    output (registers, shared memory, spills per kernel)."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    t0 = time.time()
    # One nvcc per source, all started together, then one link.
    objs = [tmp_dir / (s + ".o") for s in SOURCES]
    jobs = []
    for src, obj in zip(SOURCES, objs):
        cmd = [nvcc, *ptxas, *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", str(obj), str(CSRC / src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    logs = []
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            for _, other in jobs:
                if other.poll() is None:
                    other.kill()
                    other.wait()
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    tmp = tmp_dir / LIB_NAME
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(f"nvcc built {lib} in {time.time() - t0:.1f}s ({len(SOURCES)} sources in parallel)")
        print("\n".join(o.strip() for o in logs if o.strip()))
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    shutil.rmtree(tmp_dir, ignore_errors=True)
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry's argtypes declared."""
    lib = ctypes.CDLL(str(build()))
    for suffix, real in (("f32", _F), ("f64", _D)):
        for name in ("pair_sweep_tri", "pair_sweep"):
            fn = getattr(lib, f"ljmd_{name}_{suffix}")
            fn.argtypes = [_P, _P, _I, _I, real, real, real, _I, _P]
            fn.restype = _I
        fn = getattr(lib, f"ljmd_pair_sweep_tri_replicas_{suffix}")
        fn.argtypes = [_P, _P, _I, _I, _I, real, real, real, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_pair_terms_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_fused_dense_chunk_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, real, real, real, real,
                       real, real, _I, _I, _P, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_fused_dense_chunk_list_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       real, real, real, real, real, real, _I, _I, _I, _I, _I, _P, _P, _I,
                       _P, _P, _I, real, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_fused_dense_chunk_list_replicas_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       real, real, real, real, real, real, _I, _I, _I, _I, _I, _P, _P, _I,
                       _P, _P, _I, real, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_pair_sweep_rect_{suffix}")
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, real, real, real, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_pair_sweep_rect_replicas_{suffix}")
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, real, real, real, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_pair_sweep_rect_newton_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, real, real, real, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_pair_sweep_rect_newton_replicas_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, real, real, real, _I,
                       _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_pencil_sweep_hs_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, real, real, real, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_pencil_sweep_full_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, real, real, real, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_pencil_sweep_zband_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, real, real, real, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_fused_pencil_chunk_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, real, real, real, real, real,
                       real, _I, _I, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_fused_pencil_width_chunk_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, real, real, real, real, real,
                       real, _I, _I, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_pencil_rebin_{suffix}")
        fn.argtypes = [_P, _P, *[_P] * 5, _I, _P, *[_P] * 5, *[_P] * 9,
                       _I, _I, _I, _I, _I, _I, _I, real, real, real, real, _D, _P]
        fn.restype = _I
        fn = getattr(lib, f"ljmd_zsort_resort_{suffix}")
        fn.argtypes = [_P, _P, _I, *[_P] * 13, *[_I] * 12, *[real] * 9, _P]
        fn.restype = _I
    lib.ljmd_fused_plan.argtypes = [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.ljmd_fused_plan.restype = _I
    lib.ljmd_fused_block_threads.restype = _I
    lib.ljmd_list_plan.argtypes = [_I, _I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.ljmd_list_plan.restype = _I
    lib.ljmd_list_replicas_plan.argtypes = [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.ljmd_list_replicas_plan.restype = _I
    lib.ljmd_list_block_threads.restype = _I
    lib.ljmd_sweep_hs_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.ljmd_sweep_hs_occupancy.restype = _I
    lib.ljmd_sweep_hs_slices.restype = _I
    lib.ljmd_sweep_hs_max_sub.restype = _I
    lib.ljmd_pack_max_rows.restype = _I
    lib.ljmd_zsort_sort_shared_keys.restype = _I
    lib.ljmd_pencil_chunk_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.ljmd_pencil_chunk_occupancy.restype = _I
    lib.ljmd_pencil_chunk_slices.restype = _I
    lib.ljmd_pencil_chunk_max_sub.restype = _I
    lib.ljmd_rect_newton_plan.argtypes = [_I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.ljmd_rect_newton_plan.restype = _I
    lib.ljmd_rows_sweep_plan.argtypes = [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]
    lib.ljmd_rows_sweep_plan.restype = _I
    lib.ljmd_full_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.ljmd_full_occupancy.restype = _I
    lib.ljmd_full_block_threads.restype = _I
    lib.ljmd_full_max_sub.restype = _I
    lib.ljmd_zband_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.ljmd_zband_occupancy.restype = _I
    lib.ljmd_zband_block_threads.restype = _I
    lib.ljmd_zband_max_window_stages.restype = _I
    lib.ljmd_width_max_blocks.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.ljmd_width_max_blocks.restype = _I
    lib.ljmd_width_block_threads.restype = _I
    lib.ljmd_pack_window_lists.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.ljmd_pack_window_lists.restype = _I
    lib.ljmd_probe_transpose.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.ljmd_probe_gather.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.ljmd_probe_rowsum.argtypes = [_P, _P, _I, _I, _I, _I, _P]
    for name in ("transpose", "gather", "rowsum"):
        getattr(lib, f"ljmd_probe_{name}").restype = _I
    lib.ljmd_layout_max_blocks.argtypes = [_I, ctypes.POINTER(_I)]
    lib.ljmd_layout_max_blocks.restype = _I
    lib.ljmd_layout_body.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _F, _F, _F, _I, _I, _P]
    lib.ljmd_layout_body.restype = _I
    lib.ljmd_cuda_error_string.argtypes = [_I]
    lib.ljmd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        msg = library().ljmd_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's device pointer for a C entry, or None (null) for None."""
    return None if t is None else t.data_ptr()


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"kernels take float32 or float64, got {dtype}")


def require_cuda_rows(name: str, *tensors: torch.Tensor, replicas: bool = False) -> None:
    """Check what every row-matrix kernel takes: CUDA, float32/float64, one
    dtype and device, (8, n_pad) contiguous with n_pad a multiple of 128;
    with ``replicas``, (R, 8, n_pad) stacks of such rows, R >= 1."""
    ref = tensors[0]
    want = 3 if replicas else 2
    for t in tensors:
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{name}: all inputs must be on {ref.device}, got {t.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: mixed dtypes {ref.dtype} and {t.dtype}")
        if t.dim() != want or t.shape[-2] != 8 or t.shape != ref.shape or t.shape[0] < 1:
            shape = "(R, 8, n_pad)" if replicas else "(8, n_pad)"
            raise ValueError(f"{name}: expected {shape} rows, got {tuple(t.shape)}")
        if t.shape[-1] % 128:
            raise ValueError(f"{name}: n_pad={t.shape[-1]} must be a multiple of 128")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    dtype_suffix(ref.dtype)
