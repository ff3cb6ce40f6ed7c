"""Rank meshes for the particle-sharded path (counterpart of
``ljmd_tpu/parallel/mesh.py`` and of what ``shard_map`` gives the JAX
package: ``lax.ppermute``, ``lax.psum``, ``lax.all_gather`` and the global
``jnp.max`` of the rebin triggers).

A mesh of ``d`` ranks on the particle axis. ``mesh.run(fn, *per_rank_args)``
takes the place of ``shard_map``: it calls ``fn(comm, *args_of_rank)`` for
every rank this process holds (``mesh.local_ranks``), each ``per_rank_args``
entry being a sequence with one value per local rank, and returns the
results in that order. ``comm`` is the rank's handle:

- ``comm.rank``, ``comm.size``, ``comm.device``;
- ``comm.ppermute(t, shift)``: send ``t`` to rank ``(rank + shift) % d`` and
  receive from ``(rank - shift) % d`` (JAX's ``[(s, (s + shift) % d)]``);
- ``comm.psum(t)``, ``comm.pmax(t)``: the sum / max over ranks, added in rank
  order so the result does not depend on timing or on the transport;
- ``comm.all_gather(t)``: the ranks' tensors concatenated along dim 0 in rank
  order.

Outside ``run``, on the caller's side, ``mesh.gather(parts, dim)`` joins the
local ranks' pieces into the global tensor (every rank's, in rank order) and
``mesh.split(t, dim)`` cuts a global tensor into the local ranks' pieces;
``mesh.on_root(fn)`` runs ``fn`` once and gives every process its result.

Two meshes:

- ``ThreadMesh(d, device)``: d ranks as threads of one process on one device
  (the CPU, or the one card): the counterpart of the JAX tests' virtual CPU
  mesh. Each rank keeps its own worker thread. The ranks take turns: a token
  passes from rank to rank at each collective, so one rank runs at a time
  and a collective is a barrier that the last rank to arrive resolves for
  all (free threads contending for the GIL at every barrier cost ~1.5 ms a
  collective at d = 4, ten times the token's hand-offs). If one rank
  raises, the barrier is aborted, every waiting rank wakes, and the error is
  raised in the caller (no hang; a wait longer than ``BARRIER_TIMEOUT``
  aborts too). The kernels are built before the first thread starts. On one
  card the ranks' kernels share one stream, so a thread mesh there measures
  the decomposition's overhead, not scaling.
- ``DistMesh(group)``: one process per rank over ``torch.distributed``
  (NCCL: a rank per card; gloo: the CPU); the caller initialises the process
  group and picks the backend, nothing switches it. Point-to-point copies
  are ``batch_isend_irecv`` pairs; sums and maxima gather every rank's value
  and reduce in rank order, as ``ThreadMesh`` does.

``make_mesh(particle=d, device=..., kind="thread" | "dist")`` builds one.
``REPLICA_AXIS`` is named, but no mesh has a replica axis yet: the ensemble
(``parallel/ensemble.py``) batches its replicas on one card, and the replica
x particle mesh comes with the replica x particle step, still to port
(ROADMAP).
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


class _ThreadRank:
    """One rank of a ``ThreadMesh``. A collective posts the rank's value and
    what it wants of the others' (``pick``), and hands the token on; the
    last rank to post computes every rank's result, then each rank resumes
    in turn with its own."""

    def __init__(self, mesh: "ThreadMesh", rank: int):
        self.mesh = mesh
        self.rank = rank
        self.size = mesh.size
        self.device = mesh.device

    def _exchange(self, value, pick: Callable):
        m, r = self.mesh, self.rank
        m._slots[r], m._picks[r] = value, pick
        if r == m.size - 1:
            slots = list(m._slots)
            m._out = [m._picks[q](slots) for q in range(m.size)]
        m._pass(r)
        m._wait_turn(r)
        return m._out[r]

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
    """d ranks as worker threads of this process on one device."""

    def __init__(self, size: int, device="cpu"):
        if size < 1:
            raise ValueError(f"a mesh needs at least one rank, got {size}")
        self.size = size
        self.device = torch.device(device)
        self.local_ranks = tuple(range(size))
        if self.device.type == "cuda":
            from ljmd_tpu_torch.ops import _cuda

            _cuda.library()  # build and load before any rank thread exists
        self._slots: list = [None] * size
        self._picks: list = [None] * size
        self._out: list = [None] * size
        self._turn = [threading.Semaphore(0) for _ in range(size)]
        self._aborted = False
        self._tasks = [queue.Queue() for _ in range(size)]
        self._results: queue.Queue = queue.Queue()
        self._threads = []
        for r in range(size):
            t = threading.Thread(target=self._worker, args=(r,), daemon=True,
                                 name=f"ljmd-rank-{r}")
            t.start()
            self._threads.append(t)

    def _pass(self, r: int) -> None:
        """Hand the token to the next rank."""
        self._turn[(r + 1) % self.size].release()

    def _wait_turn(self, r: int) -> None:
        """Wait for the token; raise if the run was aborted meanwhile."""
        if not self._turn[r].acquire(timeout=BARRIER_TIMEOUT):
            self._abort()
            raise threading.BrokenBarrierError(f"rank {r} waited {BARRIER_TIMEOUT} s at a "
                                               "collective")
        if self._aborted:
            raise threading.BrokenBarrierError("another rank failed")

    def _abort(self) -> None:
        self._aborted = True
        for sem in self._turn:
            sem.release(self.size)

    def _worker(self, r: int) -> None:
        comm = _ThreadRank(self, r)
        while True:
            task = self._tasks[r].get()
            if task is None:
                return
            fn, args = task
            try:
                self._wait_turn(r)
                out = fn(comm, *args)
                if r < self.size - 1:
                    self._pass(r)  # the next rank finishes its last segment
                self._results.put((r, True, out))
            except BaseException as err:  # noqa: BLE001 - re-raised in the caller
                self._abort()
                self._results.put((r, False, err))

    def run(self, fn: Callable, *per_rank_args: Sequence) -> list:
        """fn(comm, *args of rank r) on every rank, in its thread, the ranks
        taking turns between collectives; the results in rank order. A
        rank's exception aborts the others' waits and is raised here."""
        if not self._threads:
            raise RuntimeError("this ThreadMesh is closed")
        for a in per_rank_args:
            if len(a) != self.size:
                raise ValueError(f"per-rank argument of length {len(a)} on {self.size} ranks")
        self._turn = [threading.Semaphore(0) for _ in range(self.size)]
        self._aborted = False
        for r in range(self.size):
            self._tasks[r].put((fn, tuple(a[r] for a in per_rank_args)))
        self._turn[0].release()
        results: list = [None] * self.size
        errors = {}
        for _ in range(self.size):
            r, ok, value = self._results.get()
            if ok:
                results[r] = value
            else:
                errors[r] = value
        if errors:
            # The first rank that failed for its own reason, not because
            # another rank's failure broke the barrier.
            own = [e for _, e in sorted(errors.items())
                   if not isinstance(e, threading.BrokenBarrierError)]
            raise (own or [errors[min(errors)]])[0]
        return results

    def gather(self, parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
        return torch.cat(list(parts), dim=dim)

    def split(self, t: torch.Tensor, dim: int = 0) -> list:
        return [p.contiguous() for p in torch.chunk(t, self.size, dim=dim)]

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
        self.device = mesh.device

    def ppermute(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        import torch.distributed as dist

        t = t.contiguous()
        if shift % self.size == 0:
            return t.clone()
        out = torch.empty_like(t)
        dst = self.mesh.global_rank((self.rank + shift) % self.size)
        src = self.mesh.global_rank((self.rank - shift) % self.size)
        ops = [dist.P2POp(dist.isend, t, dst, self.mesh.group),
               dist.P2POp(dist.irecv, out, src, self.mesh.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def _gathered(self, t: torch.Tensor) -> list:
        import torch.distributed as dist

        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.mesh.group)
        return parts

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return _reduce_in_order(self._gathered(t), torch.add)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return _reduce_in_order(self._gathered(t), torch.maximum)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._gathered(t), dim=0)


class DistMesh:
    """One rank per process over ``torch.distributed`` (``group``: None for
    the default group). The process group is the caller's: its backend
    (NCCL for cards, gloo for the CPU), address, world size and rank."""

    def __init__(self, group=None, device=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs torch.distributed.init_process_group first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend(group) == "nccl" else torch.device("cpu"))
        self.device = torch.device(device)
        self.local_ranks = (self.rank,)
        self._comm = _DistRank(self)

    def global_rank(self, rank: int) -> int:
        import torch.distributed as dist

        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def run(self, fn: Callable, *per_rank_args: Sequence) -> list:
        for a in per_rank_args:
            if len(a) != 1:
                raise ValueError("a DistMesh process holds one rank: one value per argument")
        return [fn(self._comm, *(a[0] for a in per_rank_args))]

    def gather(self, parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
        (part,) = parts
        return torch.cat(self._comm._gathered(part.movedim(dim, 0)), dim=0).movedim(0, dim)

    def split(self, t: torch.Tensor, dim: int = 0) -> list:
        return [torch.chunk(t, self.size, dim=dim)[self.rank].contiguous()]

    def on_root(self, fn: Callable):
        """fn() on rank 0; its tensors (a tensor or a tuple of them) sent to
        every rank, so all hold rank 0's result bit for bit."""
        import torch.distributed as dist

        out = fn() if self.rank == 0 else None
        box = [out]
        dist.broadcast_object_list(box, src=self.global_rank(0), group=self.group,
                                   device=self.device if self.device.type == "cuda" else None)
        res = box[0]
        if isinstance(res, tuple):
            return tuple(x.to(self.device) if isinstance(x, torch.Tensor) else x for x in res)
        return res.to(self.device) if isinstance(res, torch.Tensor) else res

    def close(self) -> None:
        pass


def make_mesh(particle: int = 1, device="cuda", kind: str = "thread", group=None):
    """A mesh of ``particle`` ranks (``parallel/mesh.py:27-45``, the particle
    axis only): ``kind="thread"`` a ``ThreadMesh`` on ``device``;
    ``kind="dist"`` a ``DistMesh`` over the initialised process group
    (``group``, default the world), whose size must be ``particle``."""
    if kind == "thread":
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass device='cpu' to run on the CPU)")
        return ThreadMesh(particle, device)
    if kind == "dist":
        mesh = DistMesh(group, None if device is None else device)
        if mesh.size != particle:
            raise ValueError(f"the process group has {mesh.size} ranks, asked for {particle}")
        return mesh
    raise ValueError(f"unknown mesh kind {kind!r}; expected 'thread' or 'dist'")
