"""Debug / sanitizer utilities (counterpart of ``ljmd_tpu/utils/debug.py``;
SURVEY §5.2: the reference relies on ``stop`` guards and compiler warnings).

- ``validate_state``: host-side fail-fast checks of an MDState (shapes,
  finite, wrapped positions, one shape for all four arrays): the analogue
  of the reference's precondition ``stop`` calls
  (lj_potential_energy.f90:77-82, md_means.f90:244).
- ``nan_guard``: wrap an engine so its carry holds a sticky flag, set on the
  device when a step's observables go non-finite (no host read per step);
  ``diagnostics`` reports it as ``nonfinite_observables`` (SURVEY §5.3: a
  diverged run flags itself instead of streaming garbage).
"""

from __future__ import annotations

import torch

from ljmd_tpu_torch.models.engine import Engine
from ljmd_tpu_torch.state import MDState, StepObs

__all__ = ["validate_state", "nan_guard"]


def validate_state(state: MDState, box_length: float, require_wrapped: bool = True) -> None:
    """Raise with a precise message if the state is unusable (host-side):
    ValueError for a shape or wrapping fault, FloatingPointError for NaN/inf."""
    for name in ("r", "ru", "v", "a"):
        arr = getattr(state, name)
        if arr.ndim != 2 or arr.shape[-1] != 3:
            raise ValueError(f"state.{name} must be (N, 3), got {tuple(arr.shape)}")
        if not bool(torch.isfinite(arr).all()):
            raise FloatingPointError(f"state.{name} contains NaN/inf")
    if require_wrapped:
        r = state.r
        if bool((r < 0).any()) or bool((r >= box_length).any()):
            raise ValueError("positions must be wrapped into [0, L)")
    shapes = {tuple(getattr(state, k).shape) for k in ("r", "ru", "v", "a")}
    if len(shapes) != 1:
        raise ValueError(f"state arrays disagree in shape: {shapes}")


def _obs_finite(obs: StepObs) -> torch.Tensor:
    return (torch.isfinite(obs.epot) & torch.isfinite(obs.ekin)
            & torch.isfinite(obs.d_epot) & torch.isfinite(obs.dd_epot))


def nan_guard(engine: Engine) -> Engine:
    """Wrap ``engine``: the carry becomes (carry, flag), the flag a 0-d bool
    tensor set once any step's observables are non-finite. Only ``step``
    is guarded (``step_fast`` / ``run_fast`` compute no observables), so
    the wrapped engine has neither."""

    def init(state: MDState):
        carry, obs = engine.init(state)
        return (carry, ~_obs_finite(obs)), obs

    def step(guarded):
        carry, flag = guarded
        carry, obs = engine.step(carry)
        return (carry, flag | ~_obs_finite(obs)), obs

    def diagnostics(guarded):
        carry, flag = guarded
        d = dict(engine.diagnostics(carry))
        d["nonfinite_observables"] = flag
        return d

    return Engine(init=init, step=step, get_state=lambda g: engine.get_state(g[0]),
                  diagnostics=diagnostics)
