"""Per-step pair sweeps of the row layout (counterpart of
``ops/pallas_lj.py``: ``pallas_pair_sweep_tri``, ``pallas_pair_sweep`` and
the (N, 3) force API ``lj_force_energy_pallas`` / ``make_pallas_force_fn``).

Layout: positions enter as an (8, n_pad) row matrix (rows 0..2 = x, y, z,
rows 3..7 and columns >= n zero). The output is an (8, n_pad) row matrix:

- rows 0..2: total force on particle i WITHOUT the 24 prefactor (sum over
  every j != i inside the cutoff);
- rows 3..5: the e / du / ddu partials, summed over j > i by the tri sweep
  (each pair once: totals restore with the prefactors 4 / 24) and over every
  j != i by the ordered sweep (each pair twice: prefactors 2 / 12);
- rows 6..7 and columns >= n: exactly zero (masks from global indices).

The rect sweeps of the particle-sharded path (``pallas_pair_sweep_rect``
and ``pallas_pair_sweep_rect_newton``) take one rank's i rows (8, ni_pad)
against a visiting j block (8, nj_pad) with global offsets ``gi0`` / ``gj0``
(self pairs masked by global index, padding by ``n_i`` / ``n_j``):

- ``pair_sweep_rect``: rows 0..2 the i-side force, rows 3..5 e / du / ddu of
  every (i, j) pair (ordered pairs: prefactors 2 / 12 after the cross-rank
  sum);
- ``pair_sweep_rect_newton``: each pair of the active range
  [i_lo, n_i) x [0, j_hi) once; returns (acc_i, acc_j): acc_i rows 0..2 the
  i-side forces and rows 3..5 the pair-once partials (4 / 24), acc_j rows
  0..2 the j-side reactions and rows 3..7 exactly 0.

``pair_sweep_tri``, ``pair_sweep``, ``pair_sweep_rect`` and
``pair_sweep_rect_newton`` launch ``csrc/pair_sweep_tri.cu``,
``csrc/pair_sweep.cu`` and ``csrc/pair_sweep_rect.cu`` on CUDA tensors; on
CPU tensors each takes its plain twin (a dense masked computation with the
same row contract). All divide exactly: the TPU kernels' approximate
reciprocal is not ported.

In this package "pallas" names the ordered sweep's hand-written CUDA kernel,
as the JAX package's backend of that name is its Pallas kernel: the names
``lj_force_energy_pallas`` and ``make_pallas_force_fn`` are kept so that a
reader finds the counterpart.
"""

from __future__ import annotations

import torch

from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.ops import _cuda
from ljmd_tpu_torch.ops.lj import LJResult, tail_corrections
from ljmd_tpu_torch.ops.pair_terms import lj_pair_terms_plain

__all__ = [
    "lj_force_energy_pallas",
    "make_pallas_force_fn",
    "pair_forces_plain",
    "pair_sweep",
    "pair_sweep_plain",
    "pair_sweep_rect",
    "pair_sweep_rect_newton",
    "pair_sweep_rect_newton_plain",
    "pair_sweep_rect_plain",
    "pair_sweep_tri",
    "pair_sweep_tri_plain",
]

# Columns of the row layout are padded to a multiple of this (the kernels
# take blocks of 32 particles; 128 also matches the JAX package's minimum).
ROW_PAD = 128


def _pair_geometry(pos: torch.Tensor, n: int, box_length: float,
                   lo: torch.Tensor | None = None):
    """(3, n, n) minimum-image displacements d[c, i, j] = x_i - x_j (with the
    two-float correction lo_i - lo_j when ``lo`` is given) and r^2."""
    x = pos[0:3, :n]
    d = x[:, :, None] - x[:, None, :]
    if lo is not None:
        xl = lo[0:3, :n]
        d = d + (xl[:, :, None] - xl[:, None, :])
    d = d - box_length * torch.round(d * (1.0 / box_length))
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    return d, r2


def pair_forces_plain(pos: torch.Tensor, n: int, box_length: float,
                      rc_square: float, lo: torch.Tensor | None = None,
                      gate: torch.Tensor | None = None) -> torch.Tensor:
    """(8, n_pad) rows 0..2 = force / 24 on each particle, everything else 0
    (the force-only sweep of the fused chunks). ``gate``, an (n, n) bool
    matrix, keeps only the pairs it marks."""
    d, r2 = _pair_geometry(pos, n, box_length, lo)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    mask = (r2 < rc_square) & ~eye
    if gate is not None:
        mask &= gate
    coef, _, _, _ = lj_pair_terms_plain(r2, mask, want_observables=False)
    out = torch.zeros_like(pos)
    out[0:3, :n] = (coef[None] * d).sum(dim=-1)
    return out


def _rect_terms(pos_i, pos_j, n_i, n_j, gi0, gj0, box_length, rc_square, want_observables,
                i_lo=0, j_hi=None):
    """(d (3, n_i, n_j) = x_i - x_j minimum image, coef, du, e, ddu) over the
    pairs gi != gj inside the cutoff with li >= i_lo and lj < j_hi."""
    d = pos_i[0:3, :n_i, None] - pos_j[0:3, None, :n_j]
    d = d - box_length * torch.round(d * (1.0 / box_length))
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    li = torch.arange(n_i, device=pos_i.device)
    lj = torch.arange(n_j, device=pos_i.device)
    mask = ((r2 < rc_square) & ((gi0 + li)[:, None] != (gj0 + lj)[None, :])
            & (li >= i_lo)[:, None] & (lj < (n_j if j_hi is None else j_hi))[None, :])
    return (d, *lj_pair_terms_plain(r2, mask, want_observables))


def _i_rows(pos_i, n_i, d, coef, du, e, ddu, want_observables):
    out = torch.zeros_like(pos_i)
    out[0:3, :n_i] = (coef[None] * d).sum(dim=-1)
    if want_observables:
        for row, term in ((3, e), (4, du), (5, ddu)):
            out[row, :n_i] = term.sum(dim=-1)
    return out


def _sweep_plain(pos: torch.Tensor, n: int, box_length: float, rc_square: float,
                 want_observables: bool, obs_pairs: str) -> torch.Tensor:
    """Dense twin of both sweeps (the rect twin with i = j); ``obs_pairs``
    "upper" (j > i) or "all"."""
    d, coef, du, e, ddu = _rect_terms(pos, pos, n, n, 0, 0, box_length, rc_square,
                                      want_observables)
    if want_observables and obs_pairs == "upper":
        upper = torch.triu(torch.ones(n, n, dtype=torch.bool, device=pos.device), 1)
        zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
        e, du, ddu = (torch.where(upper, t, zero) for t in (e, du, ddu))
    return _i_rows(pos, n, d, coef, du, e, ddu, want_observables)


def pair_sweep_tri_plain(pos: torch.Tensor, n: int, box_length: float,
                         rc_square: float, want_observables: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of the tri sweep (same (8, n_pad) row contract)."""
    return _sweep_plain(pos, n, box_length, rc_square, want_observables, "upper")


def pair_sweep_plain(pos: torch.Tensor, n: int, box_length: float,
                     rc_square: float, want_observables: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of the ordered sweep (same (8, n_pad) row contract:
    rows 3..5 over every j != i)."""
    return _sweep_plain(pos, n, box_length, rc_square, want_observables, "all")


def _launch(name: str, pos: torch.Tensor, n: int, box_length: float, rc_square: float,
            want_observables: bool) -> torch.Tensor:
    if pos.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {pos.device}")
    _cuda.require_cuda_rows(name, pos)
    if not 0 <= n <= pos.shape[1]:
        raise ValueError(f"{name}: n={n} outside [0, n_pad={pos.shape[1]}]")
    suffix = _cuda.dtype_suffix(pos.dtype)
    out = torch.empty_like(pos)
    lib = _cuda.library()
    with torch.cuda.device(pos.device):
        code = getattr(lib, f"ljmd_{name}_{suffix}")(
            pos.data_ptr(), out.data_ptr(), n, pos.shape[1], float(box_length),
            1.0 / float(box_length), float(rc_square), int(want_observables),
            _cuda.stream_handle(pos),
        )
    _cuda.LAUNCHES.bump(name)
    _cuda.check(code, name)
    return out


def pair_sweep_tri(pos: torch.Tensor, n: int, box_length: float,
                   rc_square: float, want_observables: bool = True) -> torch.Tensor:
    """Tri sweep of an (8, n_pad) row matrix: the CUDA kernel for a CUDA
    tensor, the plain twin for a CPU tensor."""
    if pos.device.type == "cpu":
        return pair_sweep_tri_plain(pos, n, box_length, rc_square, want_observables)
    return _launch("pair_sweep_tri", pos, n, box_length, rc_square, want_observables)


def pair_sweep(pos: torch.Tensor, n: int, box_length: float,
               rc_square: float, want_observables: bool = True) -> torch.Tensor:
    """Ordered N x N sweep of an (8, n_pad) row matrix (JAX
    ``pallas_pair_sweep``): the CUDA kernel for a CUDA tensor, the plain twin
    for a CPU tensor."""
    if pos.device.type == "cpu":
        return pair_sweep_plain(pos, n, box_length, rc_square, want_observables)
    return _launch("pair_sweep", pos, n, box_length, rc_square, want_observables)


def pair_sweep_rect_plain(pos_i, pos_j, n_i: int, n_j: int, gi0: int, gj0: int,
                          box_length: float, rc_square: float,
                          want_observables: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of the rect sweep (same (8, ni_pad) contract)."""
    d, coef, du, e, ddu = _rect_terms(pos_i, pos_j, n_i, n_j, gi0, gj0, box_length, rc_square,
                                      want_observables)
    return _i_rows(pos_i, n_i, d, coef, du, e, ddu, want_observables)


def pair_sweep_rect_newton_plain(pos_i, pos_j, n_i: int, n_j: int, gi0: int, gj0: int,
                                 box_length: float, rc_square: float, i_lo: int = 0,
                                 j_hi: int | None = None, want_observables: bool = True):
    """Plain PyTorch twin of the rect-Newton sweep: (acc_i, acc_j)."""
    d, coef, du, e, ddu = _rect_terms(pos_i, pos_j, n_i, n_j, gi0, gj0, box_length, rc_square,
                                      want_observables, i_lo, j_hi)
    out_j = torch.zeros_like(pos_j)
    out_j[0:3, :n_j] = -(coef[None] * d).sum(dim=1)
    return _i_rows(pos_i, n_i, d, coef, du, e, ddu, want_observables), out_j


def _check_rect(name, pos_i, pos_j, n_i, n_j):
    for t in (pos_i, pos_j):
        _cuda.require_cuda_rows(name, t)
    if pos_j.device != pos_i.device or pos_j.dtype != pos_i.dtype:
        raise ValueError(f"{name}: i and j rows must share device and dtype")
    if not (0 <= n_i <= pos_i.shape[1] and 0 <= n_j <= pos_j.shape[1]):
        raise ValueError(f"{name}: n_i={n_i}, n_j={n_j} outside the rows "
                         f"({pos_i.shape[1]}, {pos_j.shape[1]})")


def pair_sweep_rect(pos_i, pos_j, n_i: int, n_j: int, gi0: int, gj0: int, box_length: float,
                    rc_square: float, want_observables: bool = True) -> torch.Tensor:
    """Rect sweep of i rows against a j block (module docstring): ONE launch
    of ``csrc/pair_sweep_rect.cu`` on CUDA tensors, the twin on CPU ones."""
    if pos_i.device.type == "cpu":
        return pair_sweep_rect_plain(pos_i, pos_j, n_i, n_j, gi0, gj0, box_length, rc_square,
                                     want_observables)
    if pos_i.device.type != "cuda":
        raise ValueError(f"pair_sweep_rect: unsupported device {pos_i.device}")
    _check_rect("pair_sweep_rect", pos_i, pos_j, n_i, n_j)
    out = torch.empty_like(pos_i)
    lib = _cuda.library()
    with torch.cuda.device(pos_i.device):
        code = getattr(lib, f"ljmd_pair_sweep_rect_{_cuda.dtype_suffix(pos_i.dtype)}")(
            pos_i.data_ptr(), pos_j.data_ptr(), out.data_ptr(), n_i, pos_i.shape[1], n_j,
            pos_j.shape[1], int(gi0), int(gj0), float(box_length), 1.0 / float(box_length),
            float(rc_square), int(want_observables), _cuda.stream_handle(pos_i))
    _cuda.LAUNCHES.bump("pair_sweep_rect")
    _cuda.check(code, "pair_sweep_rect")
    return out


def pair_sweep_rect_newton(pos_i, pos_j, n_i: int, n_j: int, gi0: int, gj0: int,
                           box_length: float, rc_square: float, i_lo: int = 0,
                           j_hi: int | None = None, want_observables: bool = True):
    """Pair-once rect sweep with the j reactions over [i_lo, n_i) x
    [0, j_hi) (module docstring): ONE launch of ``csrc/pair_sweep_rect.cu``
    on CUDA tensors (i-role and j-role blocks), the twin on CPU ones.
    Returns (acc_i (8, ni_pad), acc_j (8, nj_pad))."""
    if pos_i.device.type == "cpu":
        return pair_sweep_rect_newton_plain(pos_i, pos_j, n_i, n_j, gi0, gj0, box_length,
                                            rc_square, i_lo, j_hi, want_observables)
    if pos_i.device.type != "cuda":
        raise ValueError(f"pair_sweep_rect_newton: unsupported device {pos_i.device}")
    _check_rect("pair_sweep_rect_newton", pos_i, pos_j, n_i, n_j)
    j_hi = n_j if j_hi is None else j_hi
    out_i = torch.empty_like(pos_i)
    out_j = torch.empty_like(pos_j)
    lib = _cuda.library()
    with torch.cuda.device(pos_i.device):
        code = getattr(lib, f"ljmd_pair_sweep_rect_newton_{_cuda.dtype_suffix(pos_i.dtype)}")(
            pos_i.data_ptr(), pos_j.data_ptr(), out_i.data_ptr(), out_j.data_ptr(), n_i,
            pos_i.shape[1], n_j, pos_j.shape[1], int(gi0), int(gj0), int(i_lo), int(j_hi),
            float(box_length), 1.0 / float(box_length), float(rc_square),
            int(want_observables), _cuda.stream_handle(pos_i))
    _cuda.LAUNCHES.bump("pair_sweep_rect_newton")
    _cuda.check(code, "pair_sweep_rect_newton")
    return out_i, out_j


def lj_force_energy_pallas(r: torch.Tensor, box_length: float, rc_square: float,
                           use_tail_corrections: bool = True, volume: float | None = None,
                           rc: float | None = None) -> LJResult:
    """The dense oracle's contract (``ops/lj.py``) through the ordered sweep:
    (N, 3) positions in, accelerations and the three scalar totals out, in
    r's dtype and on r's device (the kernel on a CUDA tensor, the twin on a
    CPU one). The totals are summed in float64 and cast back, as the JAX
    package does with x64 on; tail corrections as the oracle adds them."""
    n = r.shape[0]
    dtype = r.dtype
    n_pad = -(-n // ROW_PAD) * ROW_PAD
    pos = torch.zeros((8, n_pad), dtype=dtype, device=r.device)
    pos[0:3, :n] = r.T
    out = pair_sweep(pos, n, box_length, rc_square)
    a = 24.0 * out[0:3, :n].T
    sums = out[3:6, :n].to(torch.float64).sum(dim=1)
    epot, d_epot, dd_epot = 2.0 * sums[0], 12.0 * sums[1], 12.0 * sums[2]
    if use_tail_corrections:
        if volume is None or rc is None:
            raise ValueError("tail corrections require volume and rc")
        e_t, d_t, dd_t = tail_corrections(n, volume, rc)
        epot, d_epot, dd_epot = epot + e_t, d_epot + d_t, dd_epot + dd_t
    return LJResult(a=a, epot=epot.to(dtype), d_epot=d_epot.to(dtype),
                    dd_epot=dd_epot.to(dtype))


def make_pallas_force_fn(cfg: SimConfig):
    """``lj_force_energy_pallas`` bound to a config: (N, 3) -> LJResult."""
    def force(r: torch.Tensor) -> LJResult:
        return lj_force_energy_pallas(r, cfg.box_length, cfg.rc_square,
                                      cfg.use_tail_corrections, cfg.volume, cfg.rc)

    return force
