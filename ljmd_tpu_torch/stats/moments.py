"""Streaming time averages of the 11 scalar observables (counterpart of
``ljmd_tpu/stats/moments.py``; rebuild of ``scripts/stats/md_means.f90``).

Per sample (md_means.f90:221,227):
  T = 2 K / (3 N)        (3N here, 3N-3 in the coefficient module: a
                          documented reference quirk, kept)
  P = rho T + W / (3 V), with W = -d_epot

The accumulator is one (2, 11) tensor of sums and sums of squares of the
SHIFTED samples x - shift (shift = the first sample): algebraically free,
and necessary in float32, where <E^2> - <E>^2 on raw values loses all of
Etot's small NVE variance to cancellation.

Every function takes leading batch dimensions (a replica ensemble's (R,)
observables give (R, 2, 11) moments and (R, 11) means, in place of the JAX
package's ``vmap``); on unbatched (0-d) observables each computes what it
did before, op for op.
"""

from __future__ import annotations

import dataclasses

import torch

from ljmd_tpu_torch.state import StepObs

__all__ = [
    "OBSERVABLES",
    "MeansAccum",
    "MeansReport",
    "means_init",
    "means_update",
    "means_finalize",
    "instantaneous_temp_press",
]

OBSERVABLES = (
    "epot",              # U
    "ekin",              # K
    "etot",              # E = U + K
    "temp",              # T = 2K/(3N)
    "press",             # P = rho T + W/(3V)
    "ekin_inv",          # 1/K
    "d_epot",            # dU   = sum r dU/dr
    "dd_epot",           # ddU  = sum r^2 d2U/dr2
    "d_epot_ekin_inv",   # dU/K
    "d_epot2_ekin_inv",  # dU^2/K
    "dd_epot_ekin_inv",  # ddU/K
)
NUM_OBSERVABLES = len(OBSERVABLES)


@dataclasses.dataclass(frozen=True)
class MeansAccum:
    """count: number of samples; moments: (2, 11) [sums; sums of squares] of
    the shifted samples; shift: the first sample."""

    count: torch.Tensor
    moments: torch.Tensor
    shift: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MeansReport:
    """Means and stds over samples, each (11,) ordered as OBSERVABLES."""

    count: torch.Tensor
    means: torch.Tensor
    stds: torch.Tensor

    def mean(self, name: str) -> torch.Tensor:
        return self.means[..., OBSERVABLES.index(name)]

    def std(self, name: str) -> torch.Tensor:
        return self.stds[..., OBSERVABLES.index(name)]


def means_init(dtype=torch.float32, device="cpu", batch: tuple = ()) -> MeansAccum:
    """An empty accumulator; ``batch`` (e.g. ``(R,)``) prepends batch
    dimensions to every field."""
    batch = tuple(batch)
    return MeansAccum(
        count=torch.zeros(batch, dtype=dtype, device=device),
        moments=torch.zeros(batch + (2, NUM_OBSERVABLES), dtype=dtype, device=device),
        shift=torch.zeros(batch + (NUM_OBSERVABLES,), dtype=dtype, device=device),
    )


def instantaneous_temp_press(obs: StepObs, n: int, volume: float):
    """Per-sample T and P (md_means.f90:221,227)."""
    temp = 2.0 * obs.ekin / (3.0 * float(n))
    press = (n / volume) * temp + (-obs.d_epot) / (3.0 * volume)
    return temp, press


def _sample_vector(obs: StepObs, n: int, volume: float) -> torch.Tensor:
    temp, press = instantaneous_temp_press(obs, n, volume)
    ekin_inv = 1.0 / obs.ekin  # K <= 0 gives inf, caught by finiteness checks
    du = obs.d_epot
    ddu = obs.dd_epot
    return torch.stack([
        obs.epot,
        obs.ekin,
        obs.epot + obs.ekin,
        temp,
        press,
        ekin_inv,
        du,
        ddu,
        du * ekin_inv,
        du * du * ekin_inv,
        ddu * ekin_inv,
    ], dim=-1)


def means_update(acc: MeansAccum, obs: StepObs, n: int, volume: float) -> MeansAccum:
    """Add one sample (md_means_add_sample)."""
    x = _sample_vector(obs, n, volume).to(acc.moments.dtype)
    shift = torch.where(acc.count[..., None] == 0, x, acc.shift)
    dx = x - shift
    moments = acc.moments + torch.stack([dx, dx * dx], dim=-2)
    return MeansAccum(count=acc.count + 1, moments=moments, shift=shift)


def means_finalize(acc: MeansAccum) -> MeansReport:
    """Means and stds; std = sqrt(max(0, <x^2> - <x>^2)) (stats_math.f90:56-61)."""
    inv_n = 1.0 / acc.count[..., None]
    dmean = acc.moments[..., 0, :] * inv_n
    second = acc.moments[..., 1, :] * inv_n
    var = torch.clamp(second - dmean * dmean, min=0.0)
    return MeansReport(count=acc.count, means=acc.shift + dmean, stds=torch.sqrt(var))
