"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (``reference/lj.py``) in float64.

For each checked sample cycle the run hands over the port's state at the
cycle's start (S0) and end (S1) and the series column the cycle sampled;
after the window the finalized means and the engine's validity flags. The
numbers compared:

- ``force_err``: max over particles of |a_port(S1) - F_ref(r(S1))| over the
  rms of |F_ref|: the kernels' forces.
- ``obs_err``: the largest gap of the sampled U, K, E, T, P against the
  reference's at S1's positions and velocities, each over its scale (|U|,
  K, |U| + K, T, and rho T + |d_epot| / 3V for P): the kernels' energy and
  virial and the sampled step.
- ``advance_err``: from S0's positions and velocities the reference runs
  the cycle's steps; the larger of max |dr| over the rms displacement of
  the cycle and max |dv| over the rms velocity change: the integrator.
- ``means_err``: the finalized means of U, K, E, T, P against the means of
  the sampled series, each over |mean| + std: the driver's accumulator.
- ``flags``: validity flags set (``zsort_invalid``, ``pencil_overflow``,
  any replica), and ``samples_gap``: |samples the accumulator counted -
  samples the series holds|. Both exact.

A number that is not finite reads as infinity.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ljbench.reference import lj

NAMES = ("force_err", "obs_err", "advance_err", "means_err", "flags", "samples_gap")


@dataclasses.dataclass
class Cycle:
    """One checked sample cycle: the port's (R, N, 3) positions and
    velocities at its start, positions, velocities and accelerations at
    its end, and the (R, 5) column it sampled."""

    r0: torch.Tensor
    v0: torch.Tensor
    r1: torch.Tensor
    v1: torch.Tensor
    a1: torch.Tensor
    col: torch.Tensor


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _rms(x: torch.Tensor) -> float:
    return float(torch.sqrt((x * x).sum(dim=-1).mean()))


def force_err(a_port: torch.Tensor, a_ref: torch.Tensor) -> float:
    gap = (a_port.double() - a_ref.double()).norm(dim=-1).max()
    return _finite(float(gap) / _rms(a_ref.double()))


def obs_scales(obs_ref: torch.Tensor, d_epot_abs: torch.Tensor, n: int,
               volume: float) -> torch.Tensor:
    """(R, 5) scales of U, K, E, T, P: P's is rho T + |d_epot| / 3V, the
    sizes of its two terms."""
    u, k, t = obs_ref[:, 0].abs(), obs_ref[:, 1], obs_ref[:, 3]
    return torch.stack([u, k, u + k, t, (n / volume) * t + d_epot_abs / (3.0 * volume)], dim=1)


def obs_err(col: torch.Tensor, obs_ref: torch.Tensor, scales: torch.Tensor) -> float:
    return _finite(float(((col.double() - obs_ref.double()).abs() / scales.double()).max()))


def advance_err(c: Cycle, r1_ref: torch.Tensor, v1_ref: torch.Tensor, box: float) -> float:
    dr = lj.minimum_image(c.r1.double() - r1_ref.double(), box).norm(dim=-1).max()
    moved = lj.minimum_image(r1_ref.double() - c.r0.double(), box)
    dv = (c.v1.double() - v1_ref.double()).norm(dim=-1).max()
    kicked = v1_ref.double() - c.v0.double()
    return _finite(max(float(dr) / _rms(moved), float(dv) / _rms(kicked)))


def means_err(means_port: torch.Tensor, series: torch.Tensor) -> float:
    """``means_port`` (R, 5) against the reference's means of the (R, 5, S)
    series, each over |mean| + std of the samples."""
    s = series.double()
    ref = lj.means(s)
    scale = ref.abs() + s.std(dim=2, unbiased=False)
    return _finite(float(((means_port.double() - ref).abs() / scale).max()))


def cycle_readings(c: Cycle, cfg) -> dict:
    """force_err, obs_err and advance_err of one checked cycle, against the
    reference in float64."""
    box, rc, vol = cfg.box_length, cfg.rc, cfg.volume
    tail = cfg.use_tail_corrections
    a_ref, obs_ref, d_abs = lj.state_observables(c.r1.to(torch.float64), c.v1.to(torch.float64),
                                                 box, rc, vol, tail)
    r1_ref, v1_ref, _ = lj.advance(c.r0.to(torch.float64), c.v0.to(torch.float64),
                                   cfg.output_interval, box, rc, cfg.dt, vol, tail=tail)
    return {"force_err": force_err(c.a1, a_ref),
            "obs_err": obs_err(c.col, obs_ref, obs_scales(obs_ref, d_abs, cfg.n, vol)),
            "advance_err": advance_err(c, r1_ref, v1_ref, box)}


def control_cycle(c: Cycle, cfg, pair_dtype=torch.bfloat16) -> Cycle:
    """The cycle as the reference computes it with its pair terms and sums
    in ``pair_dtype`` and its state in the port's dtype, put in the port's
    place: from S0 it advances the cycle, and its accelerations and sampled
    column are its own at the state it reached. (A bfloat16 state cannot
    hold a step's move, ~0.005 against a spacing of 0.06-0.25 at these
    boxes: its positions stall, its velocities run away, and it reaches no
    finite number.)"""
    box, rc, vol = cfg.box_length, cfg.rc, cfg.volume
    tail = cfg.use_tail_corrections
    r1, v1, _ = lj.advance(c.r0, c.v0, cfg.output_interval, box, rc, cfg.dt, vol, tail=tail,
                           pair_dtype=pair_dtype)
    a1, col, _ = lj.state_observables(r1, v1, box, rc, vol, tail, pair_dtype)
    return Cycle(r0=c.r0, v0=c.v0, r1=r1, v1=v1, a1=a1, col=col)


def readings(cycles, means_port, series, flags: int, samples_gap: int, cfg) -> dict:
    """Every number compared: the worst over the checked cycles."""
    out = {"force_err": 0.0, "obs_err": 0.0, "advance_err": 0.0}
    for c in cycles:
        for k, x in cycle_readings(c, cfg).items():
            out[k] = max(out[k], x)
    out["means_err"] = means_err(means_port, series)
    out["flags"] = flags
    out["samples_gap"] = samples_gap
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, the names of the numbers over their limits)."""
    over = [k for k in NAMES if not numbers[k] <= limits[k]]
    return not over, over
