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
  0..2 the j-side reactions and rows 3..7 exactly 0. Its kernel runs blocks
  of rows of both roles in one launch: ``rect_newton_blocks`` says which are
  live, ``rect_newton_plan`` the S threads a row that the occupancy API
  gives.

The tri, ordered and rect sweeps run one role of the same row-sweep kernel
(``csrc/rows_sweep.cuh``; the ordered sweep is the rect sweep with i = j):
``rows_sweep_slices`` is its rule for S (threads a row),
``rows_sweep_blocks`` its live blocks, ``rows_sweep_plan`` (and
``pair_sweep_plan`` for the ordered sweep) the launch shape the kernel takes
on the card. That kernel and kernel 7 stage partner rows by cp.async, so
their wrappers refuse rows that do not start on a 16-byte boundary.

``pair_sweep_tri`` also takes (R, 8, n_pad) stacks of R replicas (the
ensemble's rows and zsort engines, a rank's replicas in the replica x
particle step): ONE launch of ``csrc/pair_sweep_tri.cu``'s replica kernel
(blockIdx.y the replica, the single-replica plan's S, so replica q's rows
equal a launch on replica q alone bit for bit; counted as
``pair_sweep_tri_replicas``), the twin batched on a CPU tensor. So do
``pair_sweep_rect`` and ``pair_sweep_rect_newton`` (the replica x particle
step's hops; ``csrc/pair_sweep_rect.cu``'s replica launches, counted as
``pair_sweep_rect_replicas`` / ``pair_sweep_rect_newton_replicas``): i rows
(R, 8, ni_pad) against j blocks (R, 8, nj_pad), replica q against replica
q.

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

import ctypes

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
    "pair_sweep_plan",
    "pair_sweep_rect",
    "pair_sweep_rect_newton",
    "pair_sweep_rect_newton_plain",
    "pair_sweep_rect_plain",
    "pair_sweep_tri",
    "pair_sweep_tri_plain",
    "rect_newton_blocks",
    "rect_newton_plan",
    "rows_sweep_blocks",
    "rows_sweep_plan",
    "rows_sweep_slices",
]

# Columns of the row layout are padded to a multiple of this (the kernels
# take blocks of up to 64 rows; 128 also matches the JAX package's minimum).
ROW_PAD = 128
# The row-sweep kernel's block (csrc/rows_sweep.cuh): threads, the range of S
# (threads a row, powers of two) and the live blocks an SM its S rule allows.
ROWS_THREADS = 256
ROWS_MIN_SLICES, ROWS_MAX_SLICES = 4, 128
ROWS_BLOCKS_PER_SM = 3


def _pair_geometry(pos: torch.Tensor, n: int, box_length: float,
                   lo: torch.Tensor | None = None):
    """(..., 3, n, n) minimum-image displacements d[..., c, i, j] = x_i - x_j
    (with the two-float correction lo_i - lo_j when ``lo`` is given) and
    r^2, over the leading (replica) dimensions of (..., 8, n_pad) rows."""
    x = pos[..., 0:3, :n]
    d = x[..., :, :, None] - x[..., :, None, :]
    if lo is not None:
        xl = lo[..., 0:3, :n]
        d = d + (xl[..., :, :, None] - xl[..., :, None, :])
    d = d - box_length * torch.round(d * (1.0 / box_length))
    r2 = d[..., 0, :, :] * d[..., 0, :, :] + d[..., 1, :, :] * d[..., 1, :, :] \
        + d[..., 2, :, :] * d[..., 2, :, :]
    return d, r2


def pair_forces_plain(pos: torch.Tensor, n: int, box_length: float,
                      rc_square: float, lo: torch.Tensor | None = None,
                      gate: torch.Tensor | None = None) -> torch.Tensor:
    """(..., 8, n_pad) rows 0..2 = force / 24 on each particle, everything
    else 0 (the force-only sweep of the fused chunks), for each leading
    (replica) index. ``gate``, an (n, n) bool matrix, keeps only the pairs
    it marks."""
    d, r2 = _pair_geometry(pos, n, box_length, lo)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    mask = (r2 < rc_square) & ~eye
    if gate is not None:
        mask &= gate
    coef, _, _, _ = lj_pair_terms_plain(r2, mask, want_observables=False)
    out = torch.zeros_like(pos)
    out[..., 0:3, :n] = (coef.unsqueeze(-3) * d).sum(dim=-1)
    return out


def _rect_terms(pos_i, pos_j, n_i, n_j, gi0, gj0, box_length, rc_square, want_observables):
    """(d (..., 3, n_i, n_j) = x_i - x_j minimum image, coef, du, e, ddu) over
    the pairs gi != gj inside the cutoff, for each leading (replica) index."""
    d = pos_i[..., 0:3, :n_i, None] - pos_j[..., 0:3, None, :n_j]
    d = d - box_length * torch.round(d * (1.0 / box_length))
    r2 = d[..., 0, :, :] * d[..., 0, :, :] + d[..., 1, :, :] * d[..., 1, :, :] \
        + d[..., 2, :, :] * d[..., 2, :, :]
    gi = gi0 + torch.arange(n_i, device=pos_i.device)
    gj = gj0 + torch.arange(n_j, device=pos_i.device)
    mask = (r2 < rc_square) & (gi[:, None] != gj[None, :])
    return (d, *lj_pair_terms_plain(r2, mask, want_observables))


def _i_rows(pos_i, n_i, d, coef, du, e, ddu, want_observables):
    out = torch.zeros_like(pos_i)
    out[..., 0:3, :n_i] = (coef.unsqueeze(-3) * d).sum(dim=-1)
    if want_observables:
        for row, term in ((3, e), (4, du), (5, ddu)):
            out[..., row, :n_i] = term.sum(dim=-1)
    return out


def _sweep_plain(pos: torch.Tensor, n: int, box_length: float, rc_square: float,
                 want_observables: bool, obs_pairs: str) -> torch.Tensor:
    """Dense twin of both sweeps (the rect twin with i = j) over (..., 8,
    n_pad) rows; ``obs_pairs`` "upper" (j > i) or "all"."""
    d, coef, du, e, ddu = _rect_terms(pos, pos, n, n, 0, 0, box_length, rc_square,
                                      want_observables)
    if want_observables and obs_pairs == "upper":
        upper = torch.triu(torch.ones(n, n, dtype=torch.bool, device=pos.device), 1)
        zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
        e, du, ddu = (torch.where(upper, t, zero) for t in (e, du, ddu))
    return _i_rows(pos, n, d, coef, du, e, ddu, want_observables)


def pair_sweep_tri_plain(pos: torch.Tensor, n: int, box_length: float,
                         rc_square: float, want_observables: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of the tri sweep (same (8, n_pad) row contract),
    and of its replica launch on (R, 8, n_pad) rows (each replica alone)."""
    return _sweep_plain(pos, n, box_length, rc_square, want_observables, "upper")


def pair_sweep_plain(pos: torch.Tensor, n: int, box_length: float,
                     rc_square: float, want_observables: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of the ordered sweep (same (8, n_pad) row contract:
    rows 3..5 over every j != i)."""
    return _sweep_plain(pos, n, box_length, rc_square, want_observables, "all")


def _require_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The row-sweep kernels stage rows by cp.async: 16-byte row starts."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must start on a 16-byte boundary (cp.async)")


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


def _launch_replicas(pos: torch.Tensor, n: int, box_length: float, rc_square: float,
                     want_observables: bool) -> torch.Tensor:
    name = "pair_sweep_tri_replicas"
    if pos.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {pos.device}")
    _cuda.require_cuda_rows(name, pos, replicas=True)
    if not 0 <= n <= pos.shape[-1]:
        raise ValueError(f"{name}: n={n} outside [0, n_pad={pos.shape[-1]}]")
    out = torch.empty_like(pos)
    with torch.cuda.device(pos.device):
        code = getattr(_cuda.library(), f"ljmd_{name}_{_cuda.dtype_suffix(pos.dtype)}")(
            pos.data_ptr(), out.data_ptr(), n, pos.shape[-1], pos.shape[0], float(box_length),
            1.0 / float(box_length), float(rc_square), int(want_observables),
            _cuda.stream_handle(pos))
    _cuda.LAUNCHES.bump(name)
    _cuda.check(code, name)
    return out


def pair_sweep_tri(pos: torch.Tensor, n: int, box_length: float,
                   rc_square: float, want_observables: bool = True) -> torch.Tensor:
    """Tri sweep of an (8, n_pad) row matrix, or of each replica of an (R,
    8, n_pad) stack in one launch: the CUDA kernel for a CUDA tensor, the
    plain twin for a CPU tensor."""
    if pos.device.type == "cpu":
        return pair_sweep_tri_plain(pos, n, box_length, rc_square, want_observables)
    _require_aligned("pair_sweep_tri", pos)
    if pos.dim() == 3:
        return _launch_replicas(pos, n, box_length, rc_square, want_observables)
    return _launch("pair_sweep_tri", pos, n, box_length, rc_square, want_observables)


def pair_sweep(pos: torch.Tensor, n: int, box_length: float,
               rc_square: float, want_observables: bool = True) -> torch.Tensor:
    """Ordered N x N sweep of an (8, n_pad) row matrix (JAX
    ``pallas_pair_sweep``): the CUDA kernel for a CUDA tensor, the plain twin
    for a CPU tensor."""
    if pos.device.type == "cpu":
        return pair_sweep_plain(pos, n, box_length, rc_square, want_observables)
    _require_aligned("pair_sweep", pos)
    return _launch("pair_sweep", pos, n, box_length, rc_square, want_observables)


def pair_sweep_rect_plain(pos_i, pos_j, n_i: int, n_j: int, gi0: int, gj0: int,
                          box_length: float, rc_square: float,
                          want_observables: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of the rect sweep (same (8, ni_pad) contract), and
    of its replica launch on (R, 8, ni_pad) / (R, 8, nj_pad) rows."""
    d, coef, du, e, ddu = _rect_terms(pos_i, pos_j, n_i, n_j, gi0, gj0, box_length, rc_square,
                                      want_observables)
    return _i_rows(pos_i, n_i, d, coef, du, e, ddu, want_observables)


def _newton_range(n_i: int, n_j: int, i_lo: int, j_hi: int | None) -> tuple[int, int]:
    """(i_lo, j_hi) of a rect-Newton call, j_hi None meaning n_j; raises
    outside 0 <= i_lo <= n_i, 0 <= j_hi <= n_j."""
    j_hi = n_j if j_hi is None else int(j_hi)
    if not (0 <= i_lo <= n_i and 0 <= j_hi <= n_j):
        raise ValueError(f"pair_sweep_rect_newton: active range [{i_lo}, {n_i}) x [0, {j_hi}) "
                         f"outside the rows ({n_i}, {n_j})")
    return int(i_lo), j_hi


def rect_newton_blocks(n_i: int, n_j: int, i_lo: int, j_hi: int | None, tile: int):
    """The live blocks of the rect-Newton kernel's two roles (the rule of
    ``csrc/pair_sweep_rect.cu``): blocks of ``tile`` rows, the i role's over
    the i rows and the j role's over the j rows; a block is live where its
    rows meet the role's active rows ([i_lo, n_i), [0, j_hi)) and the
    partner range ([0, j_hi), [i_lo, n_i)) is not empty. The others only
    write zeros. Returns (i-role block indices, j-role block indices), int64.

    The kernel's rule (``rows_live_blocks``) runs only on the card; this copy
    lets the CPU tests hold it against a brute-force count, and the card
    tests hold the kernel's count (``rect_newton_plan``'s ``items``) equal
    to it."""
    i_lo, j_hi = _newton_range(n_i, n_j, i_lo, j_hi)

    def live(lo, hi, partners):
        if lo >= hi or partners <= 0:
            return torch.zeros(0, dtype=torch.long)
        return torch.arange(lo // tile, (hi - 1) // tile + 1)

    return live(i_lo, n_i, j_hi), live(0, j_hi, n_i - i_lo)


def pair_sweep_rect_newton_plain(pos_i, pos_j, n_i: int, n_j: int, gi0: int, gj0: int,
                                 box_length: float, rc_square: float, i_lo: int = 0,
                                 j_hi: int | None = None, want_observables: bool = True):
    """Plain PyTorch twin of the rect-Newton sweep: (acc_i, acc_j), the
    active rows [i_lo, n_i) against the active partners [0, j_hi); on (R,
    8, n_pad) stacks, each replica's."""
    i_lo, j_hi = _newton_range(n_i, n_j, i_lo, j_hi)
    out_i, out_j = torch.zeros_like(pos_i), torch.zeros_like(pos_j)
    if i_lo == n_i or j_hi == 0:
        return out_i, out_j
    d, coef, du, e, ddu = _rect_terms(pos_i[..., i_lo:], pos_j, n_i - i_lo, j_hi, gi0 + i_lo,
                                      gj0, box_length, rc_square, want_observables)
    out_i[..., i_lo:] = _i_rows(pos_i[..., i_lo:], n_i - i_lo, d, coef, du, e, ddu,
                                want_observables)
    out_j[..., 0:3, :j_hi] = -(coef.unsqueeze(-3) * d).sum(dim=-2)
    return out_i, out_j


def _check_rect(name, pos_i, pos_j, n_i, n_j) -> list:
    """Check i and j rows ((8, ld) each, or (R, 8, ld) stacks of one R) and
    return the leading replica count as a list ([] or [R])."""
    replicas = pos_i.dim() == 3
    for t in (pos_i, pos_j):
        _cuda.require_cuda_rows(name, t, replicas=replicas)
    if pos_j.device != pos_i.device or pos_j.dtype != pos_i.dtype:
        raise ValueError(f"{name}: i and j rows must share device and dtype")
    if pos_j.shape[:-2] != pos_i.shape[:-2]:
        raise ValueError(f"{name}: i rows {tuple(pos_i.shape)} and j rows "
                         f"{tuple(pos_j.shape)} hold different replica counts")
    if not (0 <= n_i <= pos_i.shape[-1] and 0 <= n_j <= pos_j.shape[-1]):
        raise ValueError(f"{name}: n_i={n_i}, n_j={n_j} outside the rows "
                         f"({pos_i.shape[-1]}, {pos_j.shape[-1]})")
    return [pos_i.shape[0]] if replicas else []


def pair_sweep_rect(pos_i, pos_j, n_i: int, n_j: int, gi0: int, gj0: int, box_length: float,
                    rc_square: float, want_observables: bool = True) -> torch.Tensor:
    """Rect sweep of i rows against a j block (module docstring), or of
    each replica's of (R, 8, n_pad) stacks: ONE launch of
    ``csrc/pair_sweep_rect.cu`` on CUDA tensors, the twin on CPU ones."""
    if pos_i.device.type == "cpu":
        return pair_sweep_rect_plain(pos_i, pos_j, n_i, n_j, gi0, gj0, box_length, rc_square,
                                     want_observables)
    if pos_i.device.type != "cuda":
        raise ValueError(f"pair_sweep_rect: unsupported device {pos_i.device}")
    reps = _check_rect("pair_sweep_rect", pos_i, pos_j, n_i, n_j)
    _require_aligned("pair_sweep_rect", pos_i, pos_j)
    name = "pair_sweep_rect_replicas" if reps else "pair_sweep_rect"
    out = torch.empty_like(pos_i)
    lib = _cuda.library()
    with torch.cuda.device(pos_i.device):
        code = getattr(lib, f"ljmd_{name}_{_cuda.dtype_suffix(pos_i.dtype)}")(
            pos_i.data_ptr(), pos_j.data_ptr(), out.data_ptr(), n_i, pos_i.shape[-1], n_j,
            pos_j.shape[-1], *reps, int(gi0), int(gj0), float(box_length),
            1.0 / float(box_length), float(rc_square), int(want_observables),
            _cuda.stream_handle(pos_i))
    _cuda.LAUNCHES.bump(name)
    _cuda.check(code, name)
    return out


def pair_sweep_rect_newton(pos_i, pos_j, n_i: int, n_j: int, gi0: int, gj0: int,
                           box_length: float, rc_square: float, i_lo: int = 0,
                           j_hi: int | None = None, want_observables: bool = True):
    """Pair-once rect sweep with the j reactions over [i_lo, n_i) x
    [0, j_hi) (module docstring), or each replica's of (R, 8, n_pad) stacks:
    ONE launch of ``csrc/pair_sweep_rect.cu`` on CUDA tensors (i-role and
    j-role blocks), the twin on CPU ones. Returns (acc_i (8, ni_pad), acc_j
    (8, nj_pad)), with the leading R of stacks."""
    if pos_i.device.type == "cpu":
        return pair_sweep_rect_newton_plain(pos_i, pos_j, n_i, n_j, gi0, gj0, box_length,
                                            rc_square, i_lo, j_hi, want_observables)
    if pos_i.device.type != "cuda":
        raise ValueError(f"pair_sweep_rect_newton: unsupported device {pos_i.device}")
    reps = _check_rect("pair_sweep_rect_newton", pos_i, pos_j, n_i, n_j)
    i_lo, j_hi = _newton_range(n_i, n_j, i_lo, j_hi)
    _require_aligned("pair_sweep_rect_newton", pos_i, pos_j)
    name = "pair_sweep_rect_newton_replicas" if reps else "pair_sweep_rect_newton"
    out_i = torch.empty_like(pos_i)
    out_j = torch.empty_like(pos_j)
    lib = _cuda.library()
    with torch.cuda.device(pos_i.device):
        code = getattr(lib, f"ljmd_{name}_{_cuda.dtype_suffix(pos_i.dtype)}")(
            pos_i.data_ptr(), pos_j.data_ptr(), out_i.data_ptr(), out_j.data_ptr(), n_i,
            pos_i.shape[-1], n_j, pos_j.shape[-1], *reps, int(gi0), int(gj0), i_lo, j_hi,
            float(box_length), 1.0 / float(box_length), float(rc_square),
            int(want_observables), _cuda.stream_handle(pos_i))
    _cuda.LAUNCHES.bump(name)
    _cuda.check(code, name)
    return out_i, out_j


def rect_newton_plan(pos_i, pos_j, n_i: int, n_j: int, i_lo: int = 0, j_hi: int | None = None,
                     want_observables: bool = True) -> dict:
    """The rect-Newton kernel's launch shape for these rows and active range
    (on the card): threads a row (``slices``, S), rows a block (``tile``),
    live blocks of both roles (``items``; ``rect_newton_blocks``), the grid
    (``blocks``), resident blocks an SM, SMs, registers and spill bytes a
    thread, and the warps the live blocks put on each SM."""
    _check_rect("rect_newton_plan", pos_i, pos_j, n_i, n_j)
    i_lo, j_hi = _newton_range(n_i, n_j, i_lo, j_hi)
    lib = _cuda.library()
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(pos_i.device):
        _cuda.check(lib.ljmd_rect_newton_plan(pos_i.element_size(), int(want_observables),
                                              pos_i.shape[-1], pos_j.shape[-1], n_i, i_lo, j_hi,
                                              out), "rect_newton_plan")
    return _plan_dict(out)


def _plan_dict(out) -> dict:
    plan = dict(zip(("slices", "tile", "items", "blocks", "blocks_per_sm", "sms", "regs",
                     "spill_bytes"), out))
    plan["warps_per_sm"] = plan["items"] * plan["tile"] * plan["slices"] / 32 / plan["sms"]
    return plan


def rows_sweep_blocks(n_rows: int, n_cols: int, tile: int) -> int:
    """Live blocks of the row-sweep kernel (``csrc/rows_sweep.cuh``,
    ``rows_live_blocks``) for the tri and ordered sweeps (n_rows = n_cols =
    n) or the rect sweep (n_i rows against n_j partners): blocks of ``tile``
    rows that meet the rows [0, n_rows) while there is a partner. The others
    only write zeros."""
    return -(-n_rows // tile) if n_rows > 0 and n_cols > 0 else 0


def rows_sweep_slices(n_rows: int, n_cols: int, blocks_per_sm: int, sms: int) -> int:
    """S, the threads a row of the tri, ordered and rect sweeps' kernel, by
    its rule (``rows_slices`` in ``csrc/rows_sweep.cuh``): the largest power of two
    in [4, 128] whose live blocks (``rows_sweep_blocks`` at tile = 256 / S)
    all run in one wave of at most 3 blocks an SM (``blocks_per_sm``, the
    occupancy API's resident blocks, capped at 3, times ``sms``), each
    thread keeping at least one partner (n_cols >= S); where none does
    (rows far larger than the card), the smallest.

    The kernel's rule runs only on the card; this copy lets the CPU tests
    hold it to its table, and the card tests hold ``rows_sweep_plan`` equal
    to it."""
    wave = min(blocks_per_sm, ROWS_BLOCKS_PER_SM) * sms
    slices, s = ROWS_MIN_SLICES, ROWS_MIN_SLICES
    while s <= ROWS_MAX_SLICES:
        if rows_sweep_blocks(n_rows, n_cols, ROWS_THREADS // s) <= wave and n_cols >= s:
            slices = s
        s *= 2
    return slices


def rows_sweep_plan(pos_i, n_i: int, pos_j=None, n_j: int | None = None,
                    want_observables: bool = True) -> dict:
    """The launch shape (on the card) of the tri sweep over ``pos_i``'s
    first n_i rows (``pos_j`` None) or of the rect sweep of those rows
    against ``pos_j``'s first n_j: threads a row (``slices``, S;
    ``rows_sweep_slices``), rows a block (``tile``), live blocks (``items``;
    ``rows_sweep_blocks``), the grid (``blocks``), resident blocks an SM,
    SMs, registers and spill bytes a thread, and the warps the live blocks
    put on each SM."""
    upper = pos_j is None
    if upper:
        _cuda.require_cuda_rows("rows_sweep_plan", pos_i)
        n_j = n_i
        if not 0 <= n_i <= pos_i.shape[1]:
            raise ValueError(f"rows_sweep_plan: n={n_i} outside [0, n_pad={pos_i.shape[1]}]")
    else:
        _check_rect("rows_sweep_plan", pos_i, pos_j, n_i, n_j)
    lib = _cuda.library()
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(pos_i.device):
        _cuda.check(lib.ljmd_rows_sweep_plan(pos_i.element_size(), int(want_observables),
                                             int(upper), n_i, pos_i.shape[-1], n_j, out),
                    "rows_sweep_plan")
    return _plan_dict(out)


def pair_sweep_plan(pos, n: int, want_observables: bool = True) -> dict:
    """The ordered sweep's launch shape (on the card): the rect sweep's
    (``rows_sweep_plan``) with the rows of ``pos`` against themselves."""
    return rows_sweep_plan(pos, n, pos, n, want_observables)


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
