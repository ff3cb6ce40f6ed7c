"""Plain reference of the NVE Lennard-Jones fluid that the benchmark holds
the port to. It imports nothing of the port and takes nothing it made: it is
handed positions and velocities and works out the rest itself.

Physics (the reference Fortran program's conventions): pair potential
U(r) = 4 (r^-12 - r^-6) with a sharp cutoff at rc and no shift, minimum
image in a cubic box of edge L, unit masses, and mean-field tail
corrections for U, for d_epot = sum_{i<j} r dU/dr and for
dd_epot = sum_{i<j} r^2 d2U/dr2 (g(r) = 1 beyond rc). Observables:
K = 1/2 sum v^2, T = 2 K / (3 N), P = rho T - d_epot / (3 V).

Every function takes a stack of R systems, (R, N, 3), and computes in the
dtype it is given: float64 for the reference. ``pair_dtype`` computes the
pair terms and their sums (everything after the displacement) in another
dtype: the control's bfloat16 beside a float32 state.

Pairs are found by an O(N^2) minimum-image search in row blocks and kept in
a Verlet list of radius rc + skin, rebuilt whenever a particle has moved
more than skin / 2 since the last build, so no pair inside rc is missed.
"""

from __future__ import annotations

import math

import torch

# Elements of one (rows x N) block of the pair search.
BLOCK_ELEMENTS = 1 << 25


def tail_terms(n: int, volume: float, rc: float) -> tuple[float, float, float]:
    """Tail corrections of (U, d_epot, dd_epot) for n particles in volume
    V: the integrals of the pair terms from rc to infinity, times
    2 pi N^2 / V."""
    density_pairs = 2.0 * math.pi * n * n / volume
    inv3 = rc ** -3
    inv9 = rc ** -9
    e_tail = density_pairs * 4.0 * (inv9 / 9.0 - inv3 / 3.0)
    d_tail = density_pairs * 24.0 * (-2.0 * inv9 / 9.0 + inv3 / 3.0)
    dd_tail = density_pairs * 24.0 * (26.0 * inv9 / 9.0 - 7.0 * inv3 / 3.0)
    return e_tail, d_tail, dd_tail


def minimum_image(d: torch.Tensor, box: float) -> torch.Tensor:
    return d - box * torch.round(d / box)


def _blocks(n: int):
    rows = max(1, min(n, BLOCK_ELEMENTS // max(n, 1)))
    for i0 in range(0, n, rows):
        yield i0, min(n, i0 + rows)


def _block_r2(x: torch.Tensor, i0: int, i1: int, box: float) -> torch.Tensor:
    """Squared minimum-image distances of rows i0..i1 of one system's
    (N, 3) positions to every particle, (i1 - i0, N)."""
    r2 = torch.zeros((i1 - i0, x.shape[0]), dtype=x.dtype, device=x.device)
    for k in range(3):
        d = minimum_image(x[i0:i1, k, None] - x[None, :, k], box)
        r2 += d * d
    return r2


def pair_list(r: torch.Tensor, box: float, radius: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Every pair i < j of each system closer than ``radius``: two int64
    tensors of indices into the flattened (R * N) particles."""
    reps, n, _ = r.shape
    cols = torch.arange(n, device=r.device)
    ii, jj = [], []
    for q in range(reps):
        for i0, i1 in _blocks(n):
            close = ((_block_r2(r[q], i0, i1, box) < radius * radius)
                     & (cols[None, :] > cols[i0:i1, None]))
            a, b = torch.nonzero(close, as_tuple=True)
            ii.append(a + (i0 + q * n))
            jj.append(b + q * n)
    return torch.cat(ii), torch.cat(jj)


def count_pairs(r: torch.Tensor, box: float, rc: float) -> torch.Tensor:
    """(R,) number of pairs i < j of each system inside ``rc``."""
    reps, n, _ = r.shape
    cols = torch.arange(n, device=r.device)
    counts = []
    for q in range(reps):
        total = 0
        for i0, i1 in _blocks(n):
            close = (_block_r2(r[q], i0, i1, box) < rc * rc) & (cols[None, :] > cols[i0:i1, None])
            total += int(close.sum())
        counts.append(total)
    return torch.tensor(counts, dtype=torch.int64)


def forces(r: torch.Tensor, pairs, box: float, rc: float, volume: float, tail: bool = True,
           pair_dtype=None):
    """Accelerations (R, N, 3) and (R,) U, d_epot, dd_epot of the pairs of
    ``pairs`` that lie inside rc."""
    reps, n, _ = r.shape
    flat = r.reshape(reps * n, 3)
    i, j = pairs
    d = minimum_image(flat[i] - flat[j], box)
    inside = (d * d).sum(dim=1) < rc * rc
    i, j, d = i[inside], j[inside], d[inside].to(pair_dtype or r.dtype)
    r2 = (d * d).sum(dim=1)
    inv2 = 1.0 / r2
    inv6 = inv2 * inv2 * inv2
    inv12 = inv6 * inv6
    f = (24.0 * (2.0 * inv12 - inv6) * inv2)[:, None] * d
    acc = d.new_zeros((reps * n, 3)).index_add_(0, i, f).index_add_(0, j, -f)
    rep = torch.div(i, n, rounding_mode="floor")

    def per_system(x):
        return x.new_zeros((reps,)).index_add_(0, rep, x).to(r.dtype)

    epot = per_system(4.0 * (inv12 - inv6))
    d_epot = per_system(24.0 * (inv6 - 2.0 * inv12))
    dd_epot = per_system(24.0 * (26.0 * inv12 - 7.0 * inv6))
    if tail:
        e_t, d_t, dd_t = tail_terms(n, volume, rc)
        epot, d_epot, dd_epot = epot + e_t, d_epot + d_t, dd_epot + dd_t
    return acc.to(r.dtype).reshape(reps, n, 3), epot, d_epot, dd_epot


def observables(epot, d_epot, v: torch.Tensor, volume: float) -> torch.Tensor:
    """(R, 5) U, K, E, T, P of systems with (R,) U and d_epot and (R, N, 3)
    velocities: the columns of the port's sampled series."""
    n = v.shape[1]
    ekin = 0.5 * (v * v).sum(dim=(1, 2))
    temp = 2.0 * ekin / (3.0 * n)
    press = (n / volume) * temp - d_epot / (3.0 * volume)
    return torch.stack([epot, ekin, epot + ekin, temp, press], dim=1)


def state_observables(r, v, box: float, rc: float, volume: float, tail: bool = True,
                      pair_dtype=None):
    """(accelerations, (R, 5) observables, (R,) |d_epot|) of a state."""
    acc, epot, d_epot, _ = forces(r, pair_list(r, box, rc), box, rc, volume, tail, pair_dtype)
    return acc, observables(epot, d_epot, v, volume), d_epot.abs()


def advance(r: torch.Tensor, v: torch.Tensor, steps: int, box: float, rc: float, dt: float,
            volume: float, skin: float = 1.0, tail: bool = True, pair_dtype=None):
    """``steps`` velocity-Verlet steps from positions r and velocities v
    (the accelerations are worked out from r): the wrapped positions,
    velocities and accelerations at the end."""
    radius = rc + skin
    ref = r
    pairs = pair_list(r, box, radius)
    acc = forces(r, pairs, box, rc, volume, tail, pair_dtype)[0]
    for _ in range(steps):
        r = r + v * dt + acc * (0.5 * dt * dt)
        v = v + acc * (0.5 * dt)
        moved = minimum_image(r - ref, box)
        if float((moved * moved).sum(dim=2).max()) > (0.5 * skin) ** 2:
            ref = r
            pairs = pair_list(r, box, radius)
        acc = forces(r, pairs, box, rc, volume, tail, pair_dtype)[0]
        v = v + acc * (0.5 * dt)
    return r - box * torch.floor(r / box), v, acc


def means(series: torch.Tensor) -> torch.Tensor:
    """(R, 5) means over the samples of an (R, 5, S) series."""
    return series.mean(dim=2)
