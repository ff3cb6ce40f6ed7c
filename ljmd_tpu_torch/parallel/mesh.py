"""Rank meshes for the sharded paths (counterpart of
``ljmd_tpu/parallel/mesh.py`` and of what ``shard_map`` gives the JAX
package: ``lax.ppermute``, ``lax.psum``, ``lax.all_gather`` and the global
``jnp.max`` of the rebin triggers).

A mesh of ``replica x particle`` ranks: ``replica`` rows (the replica axis,
JAX's ``REPLICA_AXIS``) of ``particle`` ranks each (the particle axis). Mesh
rank ``q * particle + p`` is rank p of row q. ``mesh.run(fn,
*per_rank_args)`` takes the place of ``shard_map``: it calls ``fn(comm,
*args_of_rank)`` for every rank this process holds (``mesh.local_ranks``,
whose (row, rank) pairs are ``mesh.coords``), each ``per_rank_args`` entry
being a sequence with one value per local rank, and returns the results in
that order. ``comm`` is the rank's handle:

- ``comm.rank``, ``comm.size``: the rank on the particle axis and that
  axis's size; ``comm.replica``, ``comm.replica_size``: its row and the
  rows; ``comm.device``;
- ``comm.ppermute(t, shift)``: send ``t`` to rank ``(rank + shift) % d`` of
  the row and receive from ``(rank - shift) % d`` (JAX's ``[(s, (s + shift)
  % d)]``);
- ``comm.psum(t)``, ``comm.pmax(t)``: the sum / max over the row's ranks,
  added in rank order so the result does not depend on timing or on the
  transport;
- ``comm.all_gather(t)``: the row's tensors concatenated along dim 0 in rank
  order.

Every collective acts over the rank's row (the particle axis): the JAX
package's steps have none over the replica axis (their observables are
``P(REPLICA_AXIS)``), and every row runs the same collectives.

Outside ``run``, on the caller's side, ``mesh.split(t, dim, axis)`` cuts a
global tensor into the local ranks' pieces and ``mesh.gather(parts, dim,
axis)`` joins the local ranks' pieces into the global tensor: over each named
axis (``axis`` a name or a tuple of names, ``dim`` the tensor dimension of
each) the pieces go in that axis's order along its dimension; over an axis
not named every rank holds the whole (``split``) or a copy, whose first is
taken (``gather``: JAX's replicated out_specs). ``mesh.on_root(fn)`` runs
``fn`` once and gives every process its result.

Two meshes:

- ``ThreadMesh(particle, device, replica=1)``: the ranks as threads of one
  process on one device (the CPU, or the one card): the counterpart of the
  JAX tests' virtual CPU mesh. Each rank keeps its own worker thread. The
  ranks take turns: a token passes from mesh rank to mesh rank (every row's
  in turn) at each collective, so one rank runs at a time, and a collective
  is a barrier of its row that the row's last rank to arrive resolves for
  the row (free threads contending for the GIL at every barrier cost ~1.5 ms
  a collective at d = 4, ten times the token's hand-offs). If one rank
  raises, the barrier is aborted, every waiting rank wakes, and the error is
  raised in the caller (no hang; a wait longer than ``BARRIER_TIMEOUT``
  aborts too). The kernels are built before the first thread starts. On one
  card the ranks' kernels share one stream, so a thread mesh there measures
  the decomposition's overhead, not scaling.
- ``DistMesh(group, replica=1)``: one process per rank over
  ``torch.distributed`` (NCCL: a rank per card; gloo: the CPU); the caller
  initialises the process group and picks the backend, nothing switches it.
  With more than one row each row gets its own process group
  (``dist.new_group``), made by every process in the same order, so every
  process of the default group builds the mesh. Point-to-point copies are
  ``batch_isend_irecv`` pairs; sums and maxima gather every rank's value and
  reduce in rank order, as ``ThreadMesh`` does.

``make_mesh(particle=d, device=..., kind="thread" | "dist", replica=r)``
builds one.
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import Callable, Sequence

import torch

__all__ = ["DistMesh", "PARTICLE_AXIS", "REPLICA_AXIS", "ThreadMesh", "make_mesh"]

REPLICA_AXIS = "replica"
PARTICLE_AXIS = "particle"

# Seconds a rank waits at a collective before the mesh gives up (a rank that
# never arrives is a fault, not a slow step).
BARRIER_TIMEOUT = 600.0


def _reduce_in_order(parts: Sequence[torch.Tensor], op) -> torch.Tensor:
    return functools.reduce(op, parts[1:], parts[0].clone())


def _axes(dim, axis) -> dict:
    """{axis name: tensor dimension} of a split / gather call."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    dims = (dim,) * len(names) if isinstance(dim, int) else tuple(dim)
    if len(dims) != len(names) or not set(names) <= {REPLICA_AXIS, PARTICLE_AXIS}:
        raise ValueError(f"axes {names} / dims {dims}: expected names of "
                         f"({REPLICA_AXIS!r}, {PARTICLE_AXIS!r}), one dimension each")
    return dict(zip(names, dims))


def _assemble(grid: list, dim, axis) -> torch.Tensor:
    """The global tensor of a full (replica x particle) grid of pieces."""
    named = _axes(dim, axis)
    rows = []
    for row in grid:
        rows.append(torch.cat(list(row), dim=named[PARTICLE_AXIS])
                    if PARTICLE_AXIS in named else row[0])
    return torch.cat(rows, dim=named[REPLICA_AXIS]) if REPLICA_AXIS in named else rows[0]


def _piece(t: torch.Tensor, coord: tuple, shape: tuple, dim, axis) -> torch.Tensor:
    """Rank ``coord`` = (row, rank)'s piece of ``t`` on a (rows, ranks) mesh."""
    named = _axes(dim, axis)
    for name, k, n in ((REPLICA_AXIS, coord[0], shape[0]), (PARTICLE_AXIS, coord[1], shape[1])):
        if name in named:
            t = torch.chunk(t, n, dim=named[name])[k]
    return t.contiguous()


class _ThreadRank:
    """One rank of a ``ThreadMesh``. A collective posts the rank's value and
    what it wants of its row's (``pick``), and hands the token on; the row's
    last rank to post computes every rank of the row's result, then each
    rank resumes in turn with its own."""

    def __init__(self, mesh: "ThreadMesh", index: int):
        self.mesh = mesh
        self.index = index
        self.replica, self.rank = divmod(index, mesh.size)
        self.size = mesh.size
        self.replica_size = mesh.replica
        self.device = mesh.device

    def _exchange(self, value, pick: Callable):
        m, g = self.mesh, self.index
        m._slots[g], m._picks[g] = value, pick
        if self.rank == m.size - 1:
            first = g - self.rank
            slots = m._slots[first:g + 1]
            for k in range(first, g + 1):
                m._out[k] = m._picks[k](slots)
        m._pass(g)
        m._wait_turn(g)
        return m._out[g]

    def ppermute(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        src = (self.rank - shift) % self.size
        return self._exchange(t, lambda slots: slots[src].clone())

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._exchange(t, lambda slots: _reduce_in_order(slots, torch.add))

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._exchange(t, lambda slots: _reduce_in_order(slots, torch.maximum))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return self._exchange(t, lambda slots: torch.cat(list(slots), dim=0))


class ThreadMesh:
    """replica x size ranks as worker threads of this process on one device
    (``size`` ranks a row on the particle axis)."""

    def __init__(self, size: int, device="cpu", replica: int = 1):
        if size < 1 or replica < 1:
            raise ValueError(f"a mesh needs at least one rank on each axis, got "
                             f"{replica} replica x {size} particle")
        self.size = size
        self.replica = replica
        self.n_ranks = replica * size
        self.device = torch.device(device)
        self.local_ranks = tuple(range(self.n_ranks))
        self.coords = tuple(divmod(g, size) for g in self.local_ranks)
        if self.device.type == "cuda":
            from ljmd_tpu_torch.ops import _cuda

            _cuda.library()  # build and load before any rank thread exists
        n = self.n_ranks
        self._slots: list = [None] * n
        self._picks: list = [None] * n
        self._out: list = [None] * n
        self._turn = [threading.Semaphore(0) for _ in range(n)]
        self._aborted = False
        self._tasks = [queue.Queue() for _ in range(n)]
        self._results: queue.Queue = queue.Queue()
        self._threads = []
        for g in range(n):
            t = threading.Thread(target=self._worker, args=(g,), daemon=True,
                                 name=f"ljmd-rank-{g}")
            t.start()
            self._threads.append(t)

    def _pass(self, g: int) -> None:
        """Hand the token to the next mesh rank."""
        self._turn[(g + 1) % self.n_ranks].release()

    def _wait_turn(self, g: int) -> None:
        """Wait for the token; raise if the run was aborted meanwhile."""
        if not self._turn[g].acquire(timeout=BARRIER_TIMEOUT):
            self._abort()
            raise threading.BrokenBarrierError(f"rank {g} waited {BARRIER_TIMEOUT} s at a "
                                               "collective")
        if self._aborted:
            raise threading.BrokenBarrierError("another rank failed")

    def _abort(self) -> None:
        self._aborted = True
        for sem in self._turn:
            sem.release(self.n_ranks)

    def _worker(self, g: int) -> None:
        comm = _ThreadRank(self, g)
        while True:
            task = self._tasks[g].get()
            if task is None:
                return
            fn, args = task
            try:
                self._wait_turn(g)
                out = fn(comm, *args)
                if g < self.n_ranks - 1:
                    self._pass(g)  # the next rank finishes its last segment
                self._results.put((g, True, out))
            except BaseException as err:  # noqa: BLE001 - re-raised in the caller
                self._abort()
                self._results.put((g, False, err))

    def run(self, fn: Callable, *per_rank_args: Sequence) -> list:
        """fn(comm, *args of rank g) on every rank, in its thread, the ranks
        taking turns between collectives; the results in mesh rank order. A
        rank's exception aborts the others' waits and is raised here."""
        if not self._threads:
            raise RuntimeError("this ThreadMesh is closed")
        n = self.n_ranks
        for a in per_rank_args:
            if len(a) != n:
                raise ValueError(f"per-rank argument of length {len(a)} on {n} ranks")
        self._turn = [threading.Semaphore(0) for _ in range(n)]
        self._aborted = False
        for g in range(n):
            self._tasks[g].put((fn, tuple(a[g] for a in per_rank_args)))
        self._turn[0].release()
        results: list = [None] * n
        errors = {}
        for _ in range(n):
            g, ok, value = self._results.get()
            if ok:
                results[g] = value
            else:
                errors[g] = value
        if errors:
            # The first rank that failed for its own reason, not because
            # another rank's failure broke the barrier.
            own = [e for _, e in sorted(errors.items())
                   if not isinstance(e, threading.BrokenBarrierError)]
            raise (own or [errors[min(errors)]])[0]
        return results

    def gather(self, parts: Sequence[torch.Tensor], dim=0, axis=PARTICLE_AXIS) -> torch.Tensor:
        parts = list(parts)
        return _assemble([parts[q * self.size:(q + 1) * self.size] for q in range(self.replica)],
                         dim, axis)

    def split(self, t: torch.Tensor, dim=0, axis=PARTICLE_AXIS) -> list:
        return [_piece(t, c, (self.replica, self.size), dim, axis) for c in self.coords]

    def on_root(self, fn: Callable):
        return fn()

    def close(self) -> None:
        for q in self._tasks:
            q.put(None)
        for t in self._threads:
            t.join()
        self._threads = []


class _DistRank:
    """This process's rank of a ``DistMesh``."""

    def __init__(self, mesh: "DistMesh"):
        self.mesh = mesh
        self.rank = mesh.rank
        self.size = mesh.size
        self.replica = mesh.coords[0][0]
        self.replica_size = mesh.replica
        self.device = mesh.device

    def ppermute(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        import torch.distributed as dist

        t = t.contiguous()
        if shift % self.size == 0:
            return t.clone()
        out = torch.empty_like(t)
        dst = self.mesh.global_rank((self.rank + shift) % self.size, self.replica)
        src = self.mesh.global_rank((self.rank - shift) % self.size, self.replica)
        ops = [dist.P2POp(dist.isend, t, dst, self.mesh.row_group),
               dist.P2POp(dist.irecv, out, src, self.mesh.row_group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def _gathered(self, t: torch.Tensor) -> list:
        import torch.distributed as dist

        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.mesh.row_group)
        return parts

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return _reduce_in_order(self._gathered(t), torch.add)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return _reduce_in_order(self._gathered(t), torch.maximum)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._gathered(t), dim=0)


class DistMesh:
    """One rank per process over ``torch.distributed`` (``group``: None for
    the default group): ``replica`` rows of size / replica ranks, mesh rank
    g the group's rank g. The process group is the caller's: its backend
    (NCCL for cards, gloo for the CPU), address, world size and rank."""

    def __init__(self, group=None, device=None, replica: int = 1):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs torch.distributed.init_process_group first")
        self.group = group
        self.n_ranks = dist.get_world_size(group)
        if replica < 1 or self.n_ranks % replica:
            raise ValueError(f"{self.n_ranks} ranks do not split into {replica} replica rows")
        self.replica = replica
        self.size = self.n_ranks // replica
        index = dist.get_rank(group)
        self.local_ranks = (index,)
        self.coords = (divmod(index, self.size),)
        self.rank = self.coords[0][1]
        self.row_group = group
        if replica > 1:
            # Every process makes every row's group, in row order.
            for q in range(replica):
                members = [self._global(q * self.size + p) for p in range(self.size)]
                row = dist.new_group(members)
                if q == self.coords[0][0]:
                    self.row_group = row
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend(group) == "nccl" else torch.device("cpu"))
        self.device = torch.device(device)
        self._comm = _DistRank(self)

    def _global(self, index: int) -> int:
        import torch.distributed as dist

        return index if self.group is None else dist.get_global_rank(self.group, index)

    def global_rank(self, rank: int, replica: int = 0) -> int:
        """The global process rank of rank ``rank`` of row ``replica``."""
        return self._global(replica * self.size + rank)

    def run(self, fn: Callable, *per_rank_args: Sequence) -> list:
        for a in per_rank_args:
            if len(a) != 1:
                raise ValueError("a DistMesh process holds one rank: one value per argument")
        return [fn(self._comm, *(a[0] for a in per_rank_args))]

    def gather(self, parts: Sequence[torch.Tensor], dim=0, axis=PARTICLE_AXIS) -> torch.Tensor:
        import torch.distributed as dist

        (part,) = parts
        part = part.contiguous()
        every = [torch.empty_like(part) for _ in range(self.n_ranks)]
        dist.all_gather(every, part, group=self.group)
        return _assemble([every[q * self.size:(q + 1) * self.size] for q in range(self.replica)],
                         dim, axis)

    def split(self, t: torch.Tensor, dim=0, axis=PARTICLE_AXIS) -> list:
        return [_piece(t, self.coords[0], (self.replica, self.size), dim, axis)]

    def on_root(self, fn: Callable):
        """fn() on mesh rank 0; its tensors (a tensor or a tuple of them) sent
        to every rank, so all hold rank 0's result bit for bit."""
        import torch.distributed as dist

        out = fn() if self.local_ranks[0] == 0 else None
        box = [out]
        dist.broadcast_object_list(box, src=self.global_rank(0), group=self.group,
                                   device=self.device if self.device.type == "cuda" else None)
        res = box[0]
        if isinstance(res, tuple):
            return tuple(x.to(self.device) if isinstance(x, torch.Tensor) else x for x in res)
        return res.to(self.device) if isinstance(res, torch.Tensor) else res

    def close(self) -> None:
        pass


def make_mesh(particle: int = 1, device="cuda", kind: str = "thread", group=None,
              replica: int = 1):
    """A (replica, particle) mesh (``parallel/mesh.py:27-45``; JAX's takes
    ``replica`` first, this one ``particle``, as every particle-only caller
    passes it): ``kind="thread"`` a ``ThreadMesh`` on ``device``;
    ``kind="dist"`` a ``DistMesh`` over the initialised process group
    (``group``, default the world), whose size must be ``replica *
    particle``. Raises ValueError where the JAX package does (a mesh of more
    ranks than there are: a process group of another size) and for an axis
    of fewer than one rank."""
    if replica < 1 or particle < 1:
        raise ValueError(f"a mesh needs at least one rank on each axis, got {replica} replica "
                         f"x {particle} particle")
    if kind == "thread":
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass device='cpu' to run on the CPU)")
        return ThreadMesh(particle, device, replica)
    if kind == "dist":
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs torch.distributed.init_process_group first")
        have = dist.get_world_size(group)
        if have != replica * particle:
            raise ValueError(f"mesh needs {replica * particle} ranks ({replica} replica x "
                             f"{particle} particle), the process group has {have}")
        return DistMesh(group, None if device is None else device, replica)
    raise ValueError(f"unknown mesh kind {kind!r}; expected 'thread' or 'dist'")
