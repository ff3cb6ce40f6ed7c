"""Chunked streaming production driver with mid-run checkpoint / resume
(counterpart of ``ljmd_tpu/models/streaming.py``).

``run_production`` (models/simulation.py) keeps every sampled frame on the
device. This driver is for long trajectories and large N (SURVEY §5.4: the
reference has no mid-production checkpoint, a crashed 500k-step run restarts
from rv_init; §5.7: frames must stream, not accumulate). The sample loop runs
in chunks of ``chunk_samples`` sample cycles; after each chunk the chunk's
series and frames go to the host in one copy each, the frames are appended
to ``rva.dat`` by the native asynchronous writer (``io/trajectory.py``),
the writer is fenced (``sync``: every frame on disk), and a checkpoint
(state, the engine carry field by field, means, series so far, sample index)
replaces the last one atomically. A rerun in the same directory resumes from
it bit for bit: the carry is restored verbatim when its class, field names,
shapes and dtypes match the engine's, else the run starts again from the
checkpoint's MDState (``engine.init``) and says so on stderr. The checkpoint
is removed when the run completes.

Each sample cycle is ``simulation.sample_cycle`` and the statistics are
``simulation.finalize``, the in-memory driver's own, so the two drivers'
series agree bit for bit.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.io.checkpoint import (
    CarryArrays,
    flatten_carry,
    load_checkpoint,
    save_checkpoint,
    unflatten_carry,
)
from ljmd_tpu_torch.io.trajectory import AsyncTrajectoryWriter
from ljmd_tpu_torch.models.engine import Engine, _effective_dtype, make_engine, resolve_device
from ljmd_tpu_torch.models.simulation import (
    SimResult,
    _advance,
    _cadence,
    finalize,
    sample_cycle,
    sample_steps,
)
from ljmd_tpu_torch.state import MDState
from ljmd_tpu_torch.stats.moments import MeansAccum, means_init

__all__ = ["CHECKPOINT_NAME", "run_production_streaming"]

CHECKPOINT_NAME = "production_checkpoint.npz"


def _checkpoint_path(out_dir: str) -> str:
    return os.path.join(out_dir, CHECKPOINT_NAME)


def _save(out_dir: str, cfg: SimConfig, state: MDState, acc: MeansAccum,
          series_done: np.ndarray, sample_idx: int, ecarry) -> int:
    """Write the chunk's checkpoint; returns its bytes."""
    return save_checkpoint(_checkpoint_path(out_dir), state,
                           step=int(sample_steps(cfg)[sample_idx - 1]), means=acc,
                           series=series_done, sample_idx=sample_idx, carry=ecarry)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _restore_carry(engine: Engine, state: MDState, saved: Optional[CarryArrays]):
    """(carry, how): the saved carry verbatim ("verbatim") when its
    structure (classes and field names), every tensor's shape and every
    dtype match the engine's own carry for ``state``; else the engine's
    carry for ``state`` ("state": a correct resume, not a bit-exact one),
    with one line on stderr saying why."""
    template, _ = engine.init(state)
    structure, leaves = flatten_carry(template)
    if saved is None:
        why = "the checkpoint holds no engine carry of this package"
    elif saved.structure != structure:
        why = f"its carry is a {saved.cls}, not this engine's {type(template).__name__}"
    else:
        why = next((f"{path.rstrip('.')}: saved {a.dtype}{list(a.shape)}, engine "
                    f"{_numpy_dtype(t.dtype)}{list(t.shape)}"
                    for a, (path, t) in zip(saved.arrays, leaves)
                    if a.shape != tuple(t.shape) or a.dtype != _numpy_dtype(t.dtype)), None)
    if why is not None:
        print(f"streaming: resuming from the checkpoint's state, not its carry ({why}); "
              "the continuation is not bit-exact", file=sys.stderr)
        return template, "state"
    tensors = [torch.from_numpy(a).to(t.device) for a, (_, t) in zip(saved.arrays, leaves)]
    return unflatten_carry(template, tensors), "verbatim"


def run_production_streaming(
    cfg: SimConfig,
    state: MDState,
    out_dir: str,
    backend: str = "auto",
    chunk_samples: int = 64,
    write_frames: bool = True,
    resume: bool = True,
    engine: Optional[Engine] = None,
    device=None,
    stats: Optional[dict] = None,
) -> SimResult:
    """Streaming production run on ``device`` (default: the device ``state``
    lives on). ``rva.dat`` grows per chunk and ``production_checkpoint.npz``
    is replaced per chunk in ``out_dir``; with ``resume`` a checkpoint there
    is continued. ``state`` is the production's start (e.g. the rv_init
    state): a resumed run passes the same one, so ``make_engine`` sizes the
    cell-pair capacity from the same census. ``engine`` replaces ``backend``
    (e.g. a sharded engine); its carry must flatten into tensors,
    dataclasses and tuples. ``stats``, when given, receives the run's IO
    figures: chunks, checkpoint bytes and seconds, frames and bytes written
    and the seconds spent handing them over and fencing them, the writer
    ("native" or "python"), the resume point and how the carry came back."""
    device = resolve_device(state.device if device is None else device)
    os.makedirs(out_dir, exist_ok=True)
    engine = engine or make_engine(cfg, backend, device, state=state,
                                   sample_interval=cfg.output_interval)
    prologue, n_samples, epilogue = _cadence(cfg)
    if n_samples == 0:
        raise ValueError("no samples would be taken (check warmup_steps/output_interval/"
                         "total_steps)")
    if chunk_samples < 1:
        raise ValueError(f"chunk_samples must be >= 1, got {chunk_samples}")
    dtype = _effective_dtype(cfg)
    info = {"chunks": 0, "checkpoint_bytes": 0, "checkpoint_s": 0.0, "frames_written": 0,
            "rva_bytes": 0, "write_s": 0.0, "writer": None, "resumed_from": None,
            "carry": None}

    ckpt = _checkpoint_path(out_dir)
    rva = os.path.join(out_dir, "rva.dat")
    if resume and os.path.exists(ckpt):
        ck = load_checkpoint(ckpt, dtype=dtype, device=device)
        start_sample = ck.sample_idx
        series_done = ck.series if ck.series is not None else np.zeros((5, 0))
        if series_done.shape[1] != start_sample:
            raise ValueError(f"{ckpt}: {series_done.shape[1]} series samples for sample "
                             f"index {start_sample}")
        acc = ck.means if ck.means is not None else means_init(dtype=dtype, device=device)
        ecarry, info["carry"] = _restore_carry(engine, ck.state, ck.carry)
        info["resumed_from"] = start_sample
    else:
        start_sample = 0
        acc = means_init(dtype=dtype, device=device)
        series_done = np.zeros((5, 0), dtype=np.float64)
        # t=0 forces (md_simulation_program.f90:236)
        ecarry, _ = engine.init(state)
        ecarry, _ = _advance(engine, ecarry, prologue, want_obs=False)

    writer = None
    if write_frames:
        args = (rva, cfg.n, cfg.box_length, cfg.dt, cfg.output_interval)
        if info["resumed_from"] is None:
            writer = AsyncTrajectoryWriter(*args, n_samples)
        elif os.path.exists(rva):
            writer = AsyncTrajectoryWriter.open_for_append(*args, start_sample)
        else:
            raise ValueError(f"{ckpt} resumes at sample {start_sample} but {rva} is missing")
        info["writer"] = "native" if writer.native else "python"

    sample_idx = start_sample
    try:
        while sample_idx < n_samples:
            k = min(chunk_samples, n_samples - sample_idx)
            cols, frames = [], []
            for _ in range(k):
                ecarry, acc, col = sample_cycle(engine, cfg, ecarry, acc)
                cols.append(col)
                if writer is not None:
                    s = engine.get_state(ecarry)
                    frames.append(torch.stack([s.r, s.ru, s.v, s.a]))
            series_done = np.concatenate(
                [series_done, torch.stack(cols, dim=1).cpu().numpy().astype(np.float64)], axis=1)
            if writer is not None:
                # (k, 4, N, 3) -> one copy to the host; the writer takes float64.
                block = torch.stack(frames).cpu().numpy().astype(np.float64, copy=False)
                t0 = time.perf_counter()
                writer.append(*(block[:, f] for f in range(4)))
                # Fence before the checkpoint: the async writer returns at
                # once, so without it a kill after _save could leave rva.dat
                # shorter (or torn) than the checkpoint's sample index. With
                # it, disk frames >= checkpoint frames, and open_for_append
                # drops the extras.
                writer.sync()
                info["write_s"] += time.perf_counter() - t0
                info["frames_written"] += k
                info["rva_bytes"] += block.nbytes
            sample_idx += k
            t0 = time.perf_counter()
            info["checkpoint_bytes"] += _save(out_dir, cfg, engine.get_state(ecarry), acc,
                                              series_done, sample_idx, ecarry)
            info["checkpoint_s"] += time.perf_counter() - t0
            info["chunks"] += 1
    finally:
        if writer is not None:
            writer.close()
        if stats is not None:
            stats.update(info)

    ecarry, _ = _advance(engine, ecarry, epilogue, want_obs=False)
    series = torch.as_tensor(series_done, dtype=dtype, device=device)
    result = finalize(cfg, engine, ecarry, series, acc, None)
    # Done: the checkpoint goes, and so does a temporary file that a kill
    # in the middle of a checkpoint write left behind.
    for name in os.listdir(out_dir):
        if name == CHECKPOINT_NAME or (name.startswith(".checkpoint_")
                                       and name.endswith(".npz.tmp")):
            os.remove(os.path.join(out_dir, name))
    return result
