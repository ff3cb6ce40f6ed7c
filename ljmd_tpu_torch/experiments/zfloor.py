"""What the flag-gated dense chunk's zero-work floor is made of (the port's
``scripts/exp_zfloor.py``).

Times ``ops/fused.py::fused_dense_chunk_flags`` (kernel 8) with all-zero
flags against the melted N=4000 fluid's real flags (window rc + 0.7) at
tile_j 512, 1024, 2048 and 4096 (fewer tiles): a floor that scales with the
tile count is per-tile overhead, a flat one the per-step cost of the
integrator and the grid barrier.

Usage: python -m ljmd_tpu_torch.experiments.zfloor [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import torch

from ljmd_tpu_torch.experiments._common import best_of, device_line, melted_zsort, parser
from ljmd_tpu_torch.experiments.overhead import chunk_chain
from ljmd_tpu_torch.models.forces import resolve_device
from ljmd_tpu_torch.ops.window_lists import compute_tile_flags

# The JAX script's sizes (the tests shrink them).
NUM_CELLS = 10
MELT_STEPS = 512
CHUNK_STEPS = 8
N_CHUNKS = 125
TILES = ((128, 512), (128, 1024), (128, 2048), (128, 4096))
REPS = 3


def main(argv=None) -> list[dict]:
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    cfg, _, c = melted_zsort(device, NUM_CELLS, MELT_STEPS)
    print("melt done", flush=True)
    n, n_pad = cfg.n, c.r.shape[1]
    out = []
    for ti, tj in TILES:
        if n_pad % tj:
            continue  # the tiling must divide the padded width
        n_tiles = (n_pad // ti) * (n_pad // tj)
        flags = compute_tile_flags(c.r, n, ti, tj, cfg.box_length, cfg.rc + 0.7)

        def run(f):
            go = lambda: chunk_chain(cfg, c.r, c.v, c.a, f, N_CHUNKS, CHUNK_STEPS,  # noqa: E731
                                     ti, tj)
            go()
            return best_of(go, device, REPS) / (CHUNK_STEPS * N_CHUNKS)

        t0 = run(torch.zeros((n_tiles,), dtype=torch.int32, device=device))
        t1 = run(flags)
        act = int((flags > 0).sum())
        print(f"TI={ti} TJ={tj:5d} visits={n_tiles:4d}: "
              f"zero={t0*1e6:7.2f} real={t1*1e6:7.2f} us/step "
              f"active={act}/{n_tiles}", flush=True)
        out.append({"tile_i": ti, "tile_j": tj, "visits": n_tiles, "active": act,
                    "zero_us": 1e6 * t0, "real_us": 1e6 * t1})
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
