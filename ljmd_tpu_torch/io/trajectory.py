"""Incremental trajectory writers (counterpart of
``ljmd_tpu/io/trajectory.py``): the rva.dat streaming contract.

The reference writes every sampled frame to disk inside the MD loop
(md_simulation_program.f90:384-387): that is how it streams long
trajectories. These writers do the same with blocks of frames, so a long run
never holds its trajectory in memory (SURVEY §5.7). The file is the Fortran
format, byte for byte what ``io/fortran_records.write_rva`` writes for the
same frames.

- ``TrajectoryWriter``: synchronous, Python.
- ``AsyncTrajectoryWriter``: the native worker thread
  (``utils/native.py``); ``append`` enqueues and returns. Where the native
  library cannot be built it falls back to ``TrajectoryWriter`` and says so
  in one line on stderr (``native`` tells which one runs).
"""

from __future__ import annotations

import os
import struct
import sys

import numpy as np

from ljmd_tpu_torch.io.fortran_records import _HEADER_FMT, _xyz_to_record, write_record

__all__ = ["AsyncTrajectoryWriter", "TrajectoryWriter"]


def _truncate_to_frames(path: str, n: int, frames_present: int) -> None:
    """Cut an rva.dat to header + ``frames_present`` whole frames. A crash
    between a checkpoint and a later chunk's (possibly in-flight) frame
    write leaves the file longer than the checkpoint's frame count, or torn
    mid-record; resume drops those bytes, or the appended frames would land
    after garbage. Per frame: 4 records (r, ru, v, a) of a 4-byte marker,
    3n float64 and a 4-byte marker."""
    header_bytes = 4 + struct.calcsize(_HEADER_FMT) + 4
    frame_bytes = 4 * (4 + 24 * n + 4)
    want = header_bytes + frames_present * frame_bytes
    have = os.path.getsize(path)
    if have < want:
        raise ValueError(
            f"rva.dat at {path} holds {have} bytes but the checkpoint claims "
            f"{frames_present} frames ({want} bytes): the file cannot be "
            "resumed (was it written without the pre-checkpoint sync fence?)"
        )
    if have > want:
        os.truncate(path, want)


class TrajectoryWriter:
    """Append-oriented rva.dat writer. The header's snapshot count is
    written up front (the reference computes it before the loop,
    md_simulation_program.f90:254) and patched on close with the actual
    count, so a truncated run stays readable."""

    def __init__(self, path: str, n: int, box_length: float, dt: float,
                 output_interval: int, n_snapshots_expected: int):
        self.path = path
        self.n = n
        self._frames_written = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "wb")
        self._header_args = (n, float(box_length), float(dt), int(output_interval))
        write_record(self._f, struct.pack(_HEADER_FMT, *self._header_args,
                                          int(n_snapshots_expected)))

    def append(self, r, ru, v, a) -> None:
        """Append a block of frames; each array (n_frames, N, 3) or (N, 3)."""
        arrs = [np.asarray(x, dtype=np.float64) for x in (r, ru, v, a)]
        if arrs[0].ndim == 2:
            arrs = [x[None] for x in arrs]
        for s in range(arrs[0].shape[0]):
            for frames in arrs:
                write_record(self._f, _xyz_to_record(frames[s]))
        self._frames_written += arrs[0].shape[0]
        self._f.flush()

    @property
    def frames_written(self) -> int:
        return self._frames_written

    def sync(self) -> None:
        """Crash-consistency fence: frames flushed and fsynced. The streaming
        driver calls it before each checkpoint, so the checkpoint never
        claims more frames than the file durably holds."""
        self._f.flush()
        os.fsync(self._f.fileno())

    @classmethod
    def open_for_append(cls, path: str, n: int, box_length: float, dt: float,
                        output_interval: int, frames_present: int) -> "TrajectoryWriter":
        """Reopen a partly written rva.dat to append: the resume path of the
        streaming driver. The file is first truncated to the
        ``frames_present`` frames the checkpoint counts (a kill during a
        later chunk's write can leave extra or torn records past them);
        ``close()`` patches the header with the final total."""
        _truncate_to_frames(path, n, frames_present)
        self = cls.__new__(cls)
        self.path = path
        self.n = n
        self._frames_written = frames_present
        self._header_args = (n, float(box_length), float(dt), int(output_interval))
        self._f = open(path, "r+b")
        self._f.seek(0, os.SEEK_END)
        return self

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.flush()
        self._f.seek(4)  # past the leading record marker
        self._f.write(struct.pack(_HEADER_FMT, *self._header_args, self._frames_written))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _fallback_notice(path: str) -> None:
    print(f"trajectory: native writer unavailable, writing {path} with the Python writer",
          file=sys.stderr)


class AsyncTrajectoryWriter:
    """rva.dat writer on the native worker thread
    (``ljmd_rva_async_*`` of ``native/ljmd_native.cpp``): ``append`` enqueues
    the block and returns, so the card never waits for the disk; ``sync``
    drains, flushes and fsyncs and raises if the native side failed; the
    header is patched with the frame count on close. Same interface as
    ``TrajectoryWriter``, which it falls back to (``native`` False) where the
    native library cannot be built."""

    def __init__(self, path: str, n: int, box_length: float, dt: float,
                 output_interval: int, n_snapshots_expected: int):
        from ljmd_tpu_torch.utils import native

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.n = n
        self._frames_written = 0
        self._handle = native.async_writer_open(path, n, box_length, dt, output_interval,
                                                n_snapshots_expected)
        self._fallback = None
        if self._handle is None:
            _fallback_notice(path)
            self._fallback = TrajectoryWriter(path, n, box_length, dt, output_interval,
                                              n_snapshots_expected)

    @classmethod
    def open_for_append(cls, path, n, box_length, dt, output_interval,
                        frames_present) -> "AsyncTrajectoryWriter":
        from ljmd_tpu_torch.utils import native

        _truncate_to_frames(path, n, frames_present)
        self = cls.__new__(cls)
        self.path = path
        self.n = n
        self._frames_written = frames_present
        self._handle = native.async_writer_open(path, n, box_length, dt, output_interval, 0,
                                                append=True, frames_present=frames_present)
        self._fallback = None
        if self._handle is None:
            _fallback_notice(path)
            self._fallback = TrajectoryWriter.open_for_append(path, n, box_length, dt,
                                                              output_interval, frames_present)
        return self

    @property
    def native(self) -> bool:
        return self._fallback is None

    def sync(self) -> None:
        """Crash-consistency fence (``TrajectoryWriter.sync``): drain the
        native queue, fflush, fsync; a native failure raises."""
        from ljmd_tpu_torch.utils import native

        if self._fallback is not None:
            self._fallback.sync()
            return
        native.async_writer_sync(self._handle)

    def append(self, r, ru, v, a) -> None:
        from ljmd_tpu_torch.utils import native

        if self._fallback is not None:
            self._fallback.append(r, ru, v, a)
            self._frames_written = self._fallback.frames_written
            return
        arrs = [np.asarray(x, dtype=np.float64) for x in (r, ru, v, a)]
        native.async_writer_append(self._handle, *arrs)
        self._frames_written += 1 if arrs[0].ndim == 2 else arrs[0].shape[0]

    @property
    def frames_written(self) -> int:
        return self._frames_written

    def close(self) -> None:
        from ljmd_tpu_torch.utils import native

        if self._fallback is not None:
            self._fallback.close()
            return
        if self._handle is not None:
            handle, self._handle = self._handle, None
            native.async_writer_close(handle)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
