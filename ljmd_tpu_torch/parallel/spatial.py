"""Particle-axis (spatial) sharding of the pair sweep over a rank mesh
(counterpart of ``ljmd_tpu/parallel/spatial.py``).

Rank s holds the particles [s * N/d, (s + 1) * N/d) (JAX's ``P(particle)``)
as an MDState of (N/d, 3) tensors. Three ways to meet the other ranks'
particles:

- ``half_ring`` (default): each pair once. The self block is the tri sweep
  (``pair_sweep_tri``); hops h = 1..floor((d-1)/2) are rect-Newton sweeps
  against the visiting block (s - h), whose reaction accumulator travels
  with it (``ppermute(+1)`` of both); for even d the hop d/2 is gated so the
  two ranks holding a block pair sweep complementary halves, keyed on the
  low block's particle index (low rank: i rows >= ni/2; high rank: j rows <
  ni/2); one final ``ppermute(-total_hops)`` returns the reactions to their
  owners. Observables restore with the prefactors 4 / 24.
- ``ring``: every ordered pair. The j block rotates d - 1 times, each hop a
  rect sweep; prefactors 2 / 12.
- ``all_gather``: every rank gathers all positions (tests, oracle).

The scalar sums are ``psum``-ed. The hops always go through the kernel
wrappers (``ops/pair_sweep.py``: ``csrc/pair_sweep_tri.cu`` and
``csrc/pair_sweep_rect.cu``): on the card they launch the kernels, on CPU
tensors they take their plain twins (the counterpart of JAX's
``interpret=True``). ``all_gather`` is the plain (n, 3) sweep
``lj_rect_partials`` on every device, as JAX's is jnp.

Precision follows the single-device engines: f32 at dt <= 1e-3 (or with
``compensated_sum``) integrates with Neumaier-compensated updates, and the
per-rank carry is then (MDState, rc, vc). ``want_obs=False`` (the fast steps
of ``run_fast``) drops the observable rows inside the kernels and the psums.

``make_spatial_engine`` wraps the step as an ``Engine`` for
``run_production``: its carry is the tuple of the local ranks' carries
(``ThreadMesh``: every rank's; ``DistMesh``: this process's), ``run_fast``
runs k fast steps inside one ``mesh.run``, and ``get_state`` joins the
ranks' rows in rank order (``DistMesh``: an all-gather).

The replica x particle step (``make_ensemble_spatial_step_fn``, the JAX
package's ``vmap`` of the step inside ``shard_map``) runs on a (replica,
particle) mesh: row q of the mesh holds replicas [q R/r, (q + 1) R/r) of the
(R, N, 3) states (``shard_replica_states``), each rank their particle shard
as (R/r, N/d, 3) tensors. Every step function above takes such batches: the
rows are (R/r, 8, n_pad) stacks, each tri sweep and each hop is ONE replica
launch of kernel 2, 6 or 7 for the rank's replicas (each replica's rows bit
for bit what a one-replica launch gives them), ``ppermute`` carries the
stacks, ``psum`` sums (R/r,) vectors over the row. So replica q's state
after a step is bit for bit what ``make_spatial_step_fn`` on a particle mesh
gives replica q alone; its observables are summed per replica, over an
(R/r, n_pad) row at once, so they may round otherwise.
"""

from __future__ import annotations

import dataclasses

import torch

from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models.engine import Engine, _effective_dtype
from ljmd_tpu_torch.ops.fused import comp_add
from ljmd_tpu_torch.ops.geometry import minimum_image, wrap_positions
from ljmd_tpu_torch.ops.lj import _pair_terms, tail_corrections
from ljmd_tpu_torch.ops.pair_sweep import (
    ROW_PAD,
    pair_sweep_rect,
    pair_sweep_rect_newton,
    pair_sweep_tri,
)
from ljmd_tpu_torch.parallel.mesh import PARTICLE_AXIS, REPLICA_AXIS
from ljmd_tpu_torch.state import MDState, StepObs

__all__ = [
    "COMMS",
    "gather_replica_states",
    "lj_rect_partials",
    "make_ensemble_spatial_step_fn",
    "make_spatial_engine",
    "make_spatial_step_fn",
    "shard_replica_states",
    "shard_state",
]

COMMS = ("half_ring", "ring", "all_gather")


def lj_rect_partials(r_local, r_all, gi_offset: int, box_length: float, rc_square: float):
    """Local i rows (ni, 3), global indices from ``gi_offset``, against all
    N positions (N, 3): (a_local (ni, 3) without the 24 prefactor, e, du,
    ddu summed over ordered pairs i != j, no prefactors); for (R, ni, 3)
    against (R, N, 3), each replica's (the sums (R,))."""
    inv_l = 1.0 / box_length
    dx, dy, dz = (minimum_image(r_local[..., :, None, k] - r_all[..., None, :, k], box_length,
                                inv_l) for k in range(3))
    r2 = dx * dx + dy * dy + dz * dz
    gi = gi_offset + torch.arange(r_local.shape[-2], device=r_local.device)
    gj = torch.arange(r_all.shape[-2], device=r_local.device)
    mask = (r2 < rc_square) & (gi[:, None] != gj[None, :])
    pair_e, du_r, pair_ddu, inv_r2 = _pair_terms(r2, mask)
    coef = -du_r * inv_r2
    a = torch.stack([(coef * dx).sum(-1), (coef * dy).sum(-1), (coef * dz).sum(-1)], dim=-1)
    return a, _total(pair_e, 2), _total(du_r, 2), _total(pair_ddu, 2)


def _total(x: torch.Tensor, dims: int) -> torch.Tensor:
    """The sum over the trailing ``dims`` dimensions (a replica's own)."""
    return x.sum(dim=tuple(range(-dims, 0)))


def _to_rows(r_local: torch.Tensor) -> torch.Tensor:
    """(..., ni, 3) positions as (..., 8, n_pad) rows."""
    ni = r_local.shape[-2]
    pos = torch.zeros(r_local.shape[:-2] + (8, -(-ni // ROW_PAD) * ROW_PAD),
                      dtype=r_local.dtype, device=r_local.device)
    pos[..., 0:3, :ni] = r_local.transpose(-1, -2)
    return pos


def _from_rows(acc: torch.Tensor, ni: int):
    """(a_raw (..., ni, 3), e, du, ddu) of (..., 8, n_pad) sweep rows."""
    return (acc[..., 0:3, :ni].transpose(-1, -2), acc[..., 3, :].sum(-1),
            acc[..., 4, :].sum(-1), acc[..., 5, :].sum(-1))


def _ring_partials(comm, r_local, box_length, rc_square, want_obs=True):
    """Ring pass of j blocks: d rect sweeps, d - 1 ``ppermute(+1)`` hops.
    Returns (a_raw (ni, 3) without the 24 prefactor, e, du, ddu) over the
    ordered pairs (i local, j anywhere, i != j); for (R, ni, 3) each
    replica's."""
    ni, d = r_local.shape[-2], comm.size
    gi0 = comm.rank * ni
    pos_i = _to_rows(r_local)
    pos_j = pos_i
    acc = torch.zeros_like(pos_i)
    for s in range(d):
        gj0 = ((comm.rank - s) % d) * ni
        acc = acc + pair_sweep_rect(pos_i, pos_j, ni, ni, gi0, gj0, box_length, rc_square,
                                    want_obs)
        if s + 1 < d:
            pos_j = comm.ppermute(pos_j, 1)
    return _from_rows(acc, ni)


def _half_ring_partials(comm, r_local, box_length, rc_square, want_obs=True):
    """Pair-once half-ring decomposition (module docstring). Returns
    (a_raw (ni, 3) without the 24 prefactor, e, du, ddu) pair-once; for
    (R, ni, 3) each replica's."""
    ni, d, my = r_local.shape[-2], comm.size, comm.rank
    gi0 = my * ni
    h_full = (d - 1) // 2
    has_half = d % 2 == 0 and d > 1
    total_hops = h_full + (1 if has_half else 0)
    half = ni // 2

    def hop_range(h):
        if has_half and h == total_hops:
            return (half, ni) if my < d // 2 else (0, half)
        return 0, ni

    pos_local = _to_rows(r_local)
    acc = pair_sweep_tri(pos_local, ni, box_length, rc_square, want_obs)
    pos_j, facc = pos_local, torch.zeros_like(pos_local)
    for h in range(1, total_hops + 1):
        pos_j = comm.ppermute(pos_j, 1)
        facc = comm.ppermute(facc, 1)
        i_lo, j_hi = hop_range(h)
        out_i, out_j = pair_sweep_rect_newton(pos_local, pos_j, ni, ni, gi0, ((my - h) % d) * ni,
                                              box_length, rc_square, i_lo, j_hi, want_obs)
        acc, facc = acc + out_i, facc + out_j
    if total_hops:
        acc = acc + comm.ppermute(facc, -total_hops)  # facc rows 3..7 are zero
    return _from_rows(acc, ni)


def _make_local_step(cfg: SimConfig, comm_kind: str = "half_ring"):
    """The rank-local velocity-Verlet step (one shard): ``step_local(comm,
    carry)`` -> (carry, StepObs), with ``.init_local`` (the t=0 force
    evaluation) and ``.fast_local`` (no observables) beside it and
    ``.compensated`` (the carry is then (MDState, rc, vc)). The carry's
    tensors are (n_local, 3), or (R, n_local, 3) for R replicas (the
    observables then (R,))."""
    if comm_kind not in COMMS:
        raise ValueError(f"unknown comm {comm_kind!r}; expected one of {COMMS}")
    dtype = _effective_dtype(cfg)
    compensated = (cfg.compensated_sum or cfg.dt <= 1.0e-3) and dtype == torch.float32
    dt, half_dt, half_dt_sq = cfg.dt, 0.5 * cfg.dt, 0.5 * cfg.dt * cfg.dt
    L = cfg.box_length
    e_t, d_t, dd_t = (tail_corrections(cfg.n, cfg.volume, cfg.rc) if cfg.use_tail_corrections
                      else (0.0, 0.0, 0.0))

    def local_force(comm, r_local, want_obs=True):
        if comm_kind == "half_ring":
            a_raw, e, du, ddu = _half_ring_partials(comm, r_local, L, cfg.rc_square, want_obs)
        elif comm_kind == "ring":
            a_raw, e, du, ddu = _ring_partials(comm, r_local, L, cfg.rc_square, want_obs)
        else:
            r_all = comm.all_gather(r_local.movedim(-2, 0)).movedim(0, -2)
            a_raw, e, du, ddu = lj_rect_partials(r_local, r_all, comm.rank * r_local.shape[-2],
                                                 L, cfg.rc_square)
        if not want_obs:
            zero = torch.zeros(r_local.shape[:-2], dtype=dtype, device=r_local.device)
            return 24.0 * a_raw, zero, zero, zero
        e, du, ddu = comm.psum(e), comm.psum(du), comm.psum(ddu)
        if comm_kind == "half_ring":  # pair once
            return 24.0 * a_raw, 4.0 * e + e_t, 24.0 * du + d_t, 24.0 * ddu + dd_t
        return 24.0 * a_raw, 2.0 * e + e_t, 12.0 * du + d_t, 12.0 * ddu + dd_t

    def obs(epot, ekin, d_epot, dd_epot):
        return StepObs(epot=epot, ekin=ekin, d_epot=d_epot, dd_epot=dd_epot)

    if compensated:
        def advance(comm, carry, want_obs):
            state, rc, vc = carry
            r_raw, rc_new = comp_add(state.r, rc, state.v * dt + state.a * half_dt_sq)
            r_new = wrap_positions(r_raw, L)
            v_half, vc_half = comp_add(state.v, vc, state.a * half_dt)
            a_new, epot, d_epot, dd_epot = local_force(comm, r_new, want_obs)
            v_new, vc_new = comp_add(v_half, vc_half, a_new * half_dt)
            ru_new = state.ru + minimum_image(r_new - state.r, L)
            new = (MDState(r=r_new, ru=ru_new, v=v_new, a=a_new), rc_new, vc_new)
            if not want_obs:
                return new
            v_eff = v_new + vc_new
            return new, obs(epot, comm.psum(0.5 * _total(v_eff * v_eff, 2)), d_epot, dd_epot)

        def init_local(comm, carry):
            state, rc, vc = carry
            a_new, epot, d_epot, dd_epot = local_force(comm, state.r)
            ekin = comm.psum(0.5 * _total(state.v * state.v, 2))
            return ((MDState(r=state.r, ru=state.ru, v=state.v, a=a_new), rc, vc),
                    obs(epot, ekin, d_epot, dd_epot))
    else:
        def advance(comm, state, want_obs):
            r_new = wrap_positions(state.r + state.v * dt + state.a * half_dt_sq, L)
            v_half = state.v + state.a * half_dt
            a_new, epot, d_epot, dd_epot = local_force(comm, r_new, want_obs)
            v_new = v_half + a_new * half_dt
            ru_new = state.ru + minimum_image(r_new - state.r, L)
            new = MDState(r=r_new, ru=ru_new, v=v_new, a=a_new)
            if not want_obs:
                return new
            return new, obs(epot, comm.psum(0.5 * _total(v_new * v_new, 2)), d_epot, dd_epot)

        def init_local(comm, state):
            """t = 0 force evaluation on the shard (the reference drivers'
            initial force call, md_simulation_program.f90:236)."""
            a_new, epot, d_epot, dd_epot = local_force(comm, state.r)
            ekin = comm.psum(0.5 * _total(state.v * state.v, 2))
            return (MDState(r=state.r, ru=state.ru, v=state.v, a=a_new),
                    obs(epot, ekin, d_epot, dd_epot))

    def step_local(comm, carry):
        return advance(comm, carry, True)

    def fast_local(comm, carry):
        """Obs-free step: the same trajectory, no observable rows in the
        kernels, no psums."""
        return advance(comm, carry, False)

    step_local.init_local = init_local
    step_local.fast_local = fast_local
    step_local.compensated = compensated
    return step_local


def _check_divides(cfg: SimConfig, mesh) -> None:
    if cfg.n % mesh.size != 0:
        raise ValueError(f"N={cfg.n} not divisible by particle-axis size {mesh.size}")


def shard_state(state: MDState, mesh, cfg: SimConfig | None = None,
                compensated: bool = False) -> tuple:
    """The local ranks' shards of a global MDState (rank s: rows
    [s N/d, (s+1) N/d)), on the mesh's device (in ``cfg``'s dtype when
    given); compensated: each shard with zero rc / vc beside it."""
    dtype = state.r.dtype if cfg is None else _effective_dtype(cfg)
    state = state.to(device=mesh.device, dtype=dtype)
    fields = [mesh.split(getattr(state, k), 0) for k in ("r", "ru", "v", "a")]
    shards = tuple(MDState(*parts) for parts in zip(*fields))
    if compensated:
        return tuple((s, torch.zeros_like(s.r), torch.zeros_like(s.r)) for s in shards)
    return shards


def make_spatial_step_fn(cfg: SimConfig, mesh, comm: str = "half_ring"):
    """One velocity-Verlet step over particle shards: ``fn(carry)`` ->
    (carry, StepObs), the carry the tuple of the local ranks' MDStates
    (``shard_state``; compensated: (MDState, rc, vc) each, ``fn.compensated``
    says which). The observables come back identical on every rank. cfg.n
    must be divisible by the mesh's size."""
    _check_divides(cfg, mesh)
    step_local = _make_local_step(cfg, comm)

    def fn(carry):
        outs = mesh.run(step_local, carry)
        return tuple(c for c, _ in outs), outs[0][1]

    fn.compensated = step_local.compensated
    return fn


def make_spatial_engine(cfg: SimConfig, mesh, comm: str = "half_ring") -> Engine:
    """``Engine`` of the particle-sharded step, so ``run_production`` (the
    sampling cadence, means, correlations, artifacts) runs the multi-device
    path as it runs the single-device engines. ``run_fast(carry, k)`` runs k
    obs-free steps inside one ``mesh.run``; ``get_state`` joins the shards."""
    _check_divides(cfg, mesh)
    step_local = _make_local_step(cfg, comm)
    compensated = step_local.compensated

    def init(state: MDState):
        outs = mesh.run(step_local.init_local, shard_state(state, mesh, cfg, compensated))
        return tuple(c for c, _ in outs), outs[0][1]

    def step(carry):
        outs = mesh.run(step_local, carry)
        return tuple(c for c, _ in outs), outs[0][1]

    def chunk_local(comm_, carry, k):
        for _ in range(k):
            carry = step_local.fast_local(comm_, carry)
        return carry

    def run_fast(carry, n_steps: int):
        return tuple(mesh.run(chunk_local, carry, [n_steps] * len(carry)))

    def get_state(carry) -> MDState:
        shards = [c[0] for c in carry] if compensated else list(carry)
        v = [c[0].v + c[2] for c in carry] if compensated else [s.v for s in shards]
        return MDState(r=mesh.gather([s.r for s in shards]),
                       ru=mesh.gather([s.ru for s in shards]),
                       v=mesh.gather(v), a=mesh.gather([s.a for s in shards]))

    return Engine(init=init, step=step, get_state=get_state, diagnostics=lambda c: {},
                  step_fast=step, run_fast=run_fast)


def shard_replica_states(states: MDState, mesh, cfg: SimConfig | None = None,
                         compensated: bool = False) -> tuple:
    """The local ranks' shards of (R, N, 3) states on a (replica, particle)
    mesh (JAX's ``P(replica, particle, None)``): rank (q, s) holds replicas
    [q R/r, (q+1) R/r) and their particles [s N/d, (s+1) N/d), on the mesh's
    device (in ``cfg``'s dtype when given); compensated: each shard with
    zero rc / vc beside it."""
    replicas, n = states.r.shape[0], states.r.shape[1]
    if replicas % mesh.replica or n % mesh.size:
        raise ValueError(f"{replicas} replicas of N={n} not divisible by the mesh's "
                         f"{mesh.replica} replica x {mesh.size} particle ranks")
    dtype = states.r.dtype if cfg is None else _effective_dtype(cfg)
    states = states.to(device=mesh.device, dtype=dtype)
    axes = ((0, 1), (REPLICA_AXIS, PARTICLE_AXIS))
    fields = [mesh.split(getattr(states, k), *axes) for k in ("r", "ru", "v", "a")]
    shards = tuple(MDState(*parts) for parts in zip(*fields))
    if compensated:
        return tuple((s, torch.zeros_like(s.r), torch.zeros_like(s.r)) for s in shards)
    return shards


def gather_replica_states(carry, mesh, compensated: bool = False) -> MDState:
    """The (R, N, 3) states of the local ranks' carries (the compensation
    terms folded into v), in replica and particle order (``DistMesh``: an
    all-gather)."""
    shards = [c[0] for c in carry] if compensated else list(carry)
    v = [c[0].v + c[2] for c in carry] if compensated else [s.v for s in shards]
    axes = ((0, 1), (REPLICA_AXIS, PARTICLE_AXIS))
    return MDState(r=mesh.gather([s.r for s in shards], *axes),
                   ru=mesh.gather([s.ru for s in shards], *axes),
                   v=mesh.gather(v, *axes), a=mesh.gather([s.a for s in shards], *axes))


def make_ensemble_spatial_step_fn(cfg: SimConfig, mesh, comm: str = "half_ring"):
    """Replica x particle sharding (``parallel/spatial.py:564-610``): one
    velocity-Verlet step of every replica, the replicas over the mesh's
    replica axis and each replica's particles over its particle axis.
    ``fn(carry)`` -> (carry, StepObs of (R,) tensors, in replica order); the
    carry is the tuple of the local ranks' (R/r, N/d, 3) MDStates
    (``shard_replica_states``; compensated: (MDState, rc, vc) each,
    ``fn.compensated`` says which); ``fn.init(carry)`` is the t = 0 force
    evaluation; ``gather_replica_states`` joins a carry. Each rank's tri
    sweep and hops are replica launches of kernels 2, 6 and 7 (module
    docstring). cfg.n must be divisible by the particle axis and the
    replica count by the replica axis."""
    _check_divides(cfg, mesh)
    step_local = _make_local_step(cfg, comm)
    fields = [f.name for f in dataclasses.fields(StepObs)]

    def joined(outs):
        return tuple(c for c, _ in outs), StepObs(*(
            mesh.gather([getattr(o, f) for _, o in outs], 0, REPLICA_AXIS) for f in fields))

    def fn(carry):
        return joined(mesh.run(step_local, carry))

    fn.init = lambda carry: joined(mesh.run(step_local.init_local, carry))
    fn.compensated = step_local.compensated
    return fn
