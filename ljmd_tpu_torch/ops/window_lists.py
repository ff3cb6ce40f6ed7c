"""Tile-pair flags and visit lists of the z-sorted window-list engine
(counterpart of ``ops/pallas_fused.py``: ``compute_tile_flags``,
``_window_max_t``, ``build_window_lists_pallas``).

The zsort engine keeps particles in sorted column order (ascending z, or
(x-slab, z)); ``compute_tile_flags`` marks which (128-column block,
128-column block) pairs can hold a pair within the window, and the visit
list pack turns those flags into per-category lists of (i-block, j-start)
visits for ``ops/fused_list.py``.

List layout (``tail_tiles=True``, the engine default): ``tiles`` is
``(9 + 2 * n_tails, max_t)`` int32, ``tcounts`` ``(4 + n_tails,)`` int32.

- rows 0/1, 2/3, 4/5, 6/7: the i-block / j-start (both in ``tile_i`` units)
  of the four visit categories: 0 "free" (no minimum-image round on x or z),
  1 "x-only" (no z round), 2 "full", 3 "masked" (rank / padding / jmin masks
  and every round);
- row 8: the masked category's jmin block (0 = no prefix mask);
- rows 9 + 2 (w - 1) / + 1: the width-w tail lists (w in 1 .. span - 1),
  counts at ``tcounts[4 + w - 1]``.

Entries past the counts are unspecified unless ``zero_fill`` is set; the
chunk kernel never reads them.

``build_window_lists`` launches ``csrc/pack_window_lists.cu`` on a CUDA
tensor (one device operation: the kernel finds each row's band itself) and
runs the plain twin ``build_window_lists_plain`` (the sequential greedy cover
of the Pallas kernel ``_pack_window_kernel``, in Python) on a CPU tensor.

Replicas (the batched zsort engine): ``compute_tile_flags`` takes (R, 8,
n_pad) rows and gives (R, n_i * n_j) flags, each replica's its own;
``build_window_lists`` takes those and gives (R, rows, max_t) lists and (R,
n_cats) counts in ONE launch of the pack kernel's replica kernel (a block a
replica, counted as ``build_window_lists_replicas``), the twin replica by
replica on a CPU tensor.
``build_window_lists_bitmask`` is the kernel's own form in plain Python (row
bitmasks walked by first set bit, counts, an exclusive scan in the kernel's
lane order, a second walk that writes): the CPU tests hold it to the twin
and to the JAX kernel; nothing on the CUDA path calls it.
"""

from __future__ import annotations

import functools

import torch

from ljmd_tpu_torch.ops import _cuda

__all__ = [
    "build_window_lists",
    "build_window_lists_bitmask",
    "build_window_lists_plain",
    "compute_tile_flags",
    "list_layout",
    "row_spans",
    "window_max_t",
]

# Most categories the pack kernel takes: 4 + (span - 1) tails, span <= 8.
MAX_SPAN = 8


def compute_tile_flags(r: torch.Tensor, n: int, tile_i: int, tile_j: int,
                       box_length: float, window: float,
                       face_margin: float | None = None,
                       x_window: float | None = None,
                       cross_margin: float | None = None) -> torch.Tensor:
    """(n_i * n_j,) int32 tile-pair flags for a SORTED (8, n_pad) layout
    (for (R, 8, n_pad) rows, (R, n_i * n_j): each replica's):
    bit 0 active, bit 1 z round needed, bit 2 x round needed (0 = never
    visited). A tile pair is active iff on every tested axis the circular gap
    between the two column sets' coordinate intervals is below the axis
    window; with ``x_window=None`` only z is tested and bit 2 rides on every
    active tile. A round is needed for a wrapped-image overlap, or when one
    side could cross a face before the next resort (within ``cross_margin``
    of it) while the other is within ``face_margin`` of the same face.
    Columns >= n are excluded; all-padding tiles are inactive."""
    n_pad = r.shape[-1]
    batch = r.shape[:-2]
    L = box_length
    inf = float("inf")  # a Python scalar: a device tensor made from it would sync
    real = torch.arange(n_pad, device=r.device) < n
    if face_margin is None:
        face_margin = window
    if cross_margin is None:
        cross_margin = face_margin

    def axis_terms(coord, win):
        x = torch.where(real, coord, inf)

        def intervals(tile):
            xt = x.reshape(*batch, n_pad // tile, tile)
            lo = xt.amin(dim=-1)
            hi = torch.where(torch.isfinite(xt), xt, -inf).amax(dim=-1)
            return lo, hi  # lo = +inf / hi = -inf for all-padding tiles

        i_lo, i_hi = intervals(tile_i)
        j_lo, j_hi = intervals(tile_j)

        def gap(a_lo, a_hi, b_lo, b_hi):
            return torch.clamp(torch.maximum(b_lo - a_hi, a_lo - b_hi), min=0.0)

        a_lo, a_hi = i_lo[..., :, None], i_hi[..., :, None]
        b_lo, b_hi = j_lo[..., None, :], j_hi[..., None, :]
        finite = torch.isfinite(a_hi) & torch.isfinite(b_hi)
        direct = (gap(a_lo, a_hi, b_lo, b_hi) < win) & finite
        wrapped = (torch.minimum(gap(a_lo, a_hi, b_lo - L, b_hi - L),
                                 gap(a_lo, a_hi, b_lo + L, b_hi + L)) < win) & finite
        s0_i, sl_i = i_lo < cross_margin, i_hi > L - cross_margin
        b0_i, bl_i = i_lo < face_margin, i_hi > L - face_margin
        s0_j, sl_j = j_lo < cross_margin, j_hi > L - cross_margin
        b0_j, bl_j = j_lo < face_margin, j_hi > L - face_margin
        hazard = ((s0_i[..., :, None] & b0_j[..., None, :])
                  | (b0_i[..., :, None] & s0_j[..., None, :])
                  | (sl_i[..., :, None] & bl_j[..., None, :])
                  | (bl_i[..., :, None] & sl_j[..., None, :]))
        return direct | wrapped, wrapped | (direct & hazard)

    active, round_z = axis_terms(r[..., 2, :], window)
    if x_window is None:
        round_x = active
    else:
        active_x, round_x = axis_terms(r[..., 0, :], x_window)
        active = active & active_x
    flags = 1 + 2 * round_z.to(torch.int32) + 4 * round_x.to(torch.int32)
    return torch.where(active, flags, torch.zeros_like(flags)).reshape(*batch, -1)


def window_max_t(n_pad: int, tile_i: int, tile_j: int) -> int:
    """Visit-list capacity: emissions within a row are >= span blocks apart,
    so a row holds at most ceil(n_b / span) visits."""
    span = tile_j // tile_i
    n_b = n_pad // tile_i
    return (n_pad // tile_i) * (-(-n_b // span))


def list_layout(n_pad: int, tile_i: int, tile_j: int, tail_tiles: bool):
    """(n_tails, rows of ``tiles``, max_t, entries of ``tcounts``)."""
    span = tile_j // tile_i
    n_tails = span - 1 if tail_tiles and span > 1 else 0
    return n_tails, 9 + 2 * n_tails, window_max_t(n_pad, tile_i, tile_j), 4 + n_tails


def row_spans(flags: torch.Tensor, n_b: int) -> torch.Tensor:
    """(2, n_i) int32 per-row active-block band [first, last + 1) of the
    (n_i * n_b,) flags; rows with no active block get [n_b, 0)."""
    f2 = flags.reshape(-1, n_b) > 0
    b_idx = torch.arange(n_b, dtype=torch.int32, device=flags.device)[None, :]
    any_row = f2.any(dim=1)
    first = torch.where(f2, b_idx, n_b).amin(dim=1)
    last1 = torch.where(f2, b_idx + 1, 0).amax(dim=1)
    return torch.stack([torch.where(any_row, first, n_b),
                        torch.where(any_row, last1, 0)]).to(torch.int32)


def _check_geometry(n: int, n_pad: int, tile_i: int, tile_j: int) -> None:
    if tile_i <= 0 or n_pad % tile_i or tile_j % tile_i or tile_j > n_pad:
        raise ValueError(f"window lists: tile_i={tile_i} must divide n_pad={n_pad} and "
                         f"tile_j={tile_j} (<= n_pad)")
    if tile_j // tile_i > MAX_SPAN:
        raise ValueError(f"window lists: span tile_j/tile_i={tile_j // tile_i} > {MAX_SPAN}")
    if not 0 <= n <= n_pad:
        raise ValueError(f"window lists: n={n} outside [0, n_pad={n_pad}]")


def build_window_lists_plain(flags: torch.Tensor, n: int, n_pad: int, tile_i: int,
                             tile_j: int, tail_tiles: bool = True):
    """Plain twin of the pack kernel: the Pallas kernel's sequential greedy
    cover, row by row. Per i-row, scan the active blocks of the row's band
    at or above the diagonal; the first uncovered one emits a visit starting
    there (clamped to n_b - span, with jmin = the block when clamped) and
    covers span blocks. With tails, an emission whose last active block in
    its window lies w < span blocks ahead goes to the width-w tail list.
    Entries past the counts are zero."""
    _check_geometry(n, n_pad, tile_i, tile_j)
    g = tile_i
    span = tile_j // g
    n_b = n_pad // g
    n_tails, n_rows, max_t, n_cats = list_layout(n_pad, tile_i, tile_j, tail_tiles)
    f = flags.reshape(-1).tolist()
    first, last1 = row_spans(flags.cpu(), n_b).tolist()
    tiles = [[0] * max_t for _ in range(n_rows)]
    counts = [0] * n_cats
    max_start = n_b - span
    for row in range(n_b):
        covered = 0
        base = row * n_b
        for b in range(max(first[row], row), last1[row]):
            fb = f[base + b]
            if not (fb > 0 and b >= covered):
                continue
            s = min(b, max_start)
            zneed, xneed, width = fb & 2, fb & 4, 1
            for k in range(1, span):
                if b + k < n_b:
                    fz = f[base + b + k]
                    zneed |= fz & 2
                    xneed |= fz & 4
                    if n_tails and fz > 0:
                        width = k + 1
            if n_tails and width < span:
                c = 4 + width - 1
                tiles[9 + 2 * (width - 1)][counts[c]] = row
                tiles[9 + 2 * (width - 1) + 1][counts[c]] = b
                counts[c] += 1
            else:
                needs_mask = (s * g < row * g + g or s * g + tile_j > n
                              or row * g + g > n or b > s)
                cat = 3 if needs_mask else (2 if zneed else (1 if xneed else 0))
                tiles[2 * cat][counts[cat]] = row
                tiles[2 * cat + 1][counts[cat]] = s
                if cat == 3:
                    tiles[8][counts[cat]] = b if b > s else 0
                counts[cat] += 1
            covered = b + span
    dev = flags.device
    return (torch.tensor(tiles, dtype=torch.int32, device=dev),
            torch.tensor(counts, dtype=torch.int32, device=dev))


def _scan_rows(counts: list) -> tuple[list, list]:
    """The kernel's exclusive scan of per-row category counts (a list of
    n_b lists), in its order: per category, lane l of a warp sums its run of
    q = ceil(n_b / 32) rows [l q, l q + q), the lane totals are scanned, and
    lane l's rows take its exclusive total plus the counts before them in
    its run. Returns (offsets per row, totals)."""
    n_b = len(counts)
    q = -(-n_b // 32)
    n_cats = len(counts[0]) if counts else 0
    offs = [[0] * n_cats for _ in range(n_b)]
    totals = []
    for c in range(n_cats):
        acc = 0
        for lane in range(32):
            for r in range(min(lane * q, n_b), min(lane * q + q, n_b)):
                offs[r][c] = acc
                acc += counts[r][c]
        totals.append(acc)
    return offs, totals


def build_window_lists_bitmask(flags: torch.Tensor, n: int, n_pad: int, tile_i: int,
                               tile_j: int, tail_tiles: bool = True):
    """The pack kernel's form in plain Python (``csrc/pack_window_lists.cu``),
    the same lists as ``build_window_lists_plain``: each row's flags become
    three bitmasks (active ``f > 0``, z round ``f & 2``, x round ``f & 4``;
    the kernel holds them 32 flags a word, a word a lane); the cover walks
    the active mask from its first set bit at or past the diagonal, a visit
    a step, reading the window's z / x needs and the tail width as bits
    [b, b + span) of the masks; pass 1 counts each row's visits per
    category, ``_scan_rows`` turns the counts into offsets, and pass 2 walks
    again and writes each visit at its offset. Entries past the counts are
    zero. Used by the CPU tests only."""
    _check_geometry(n, n_pad, tile_i, tile_j)
    g = tile_i
    span = tile_j // g
    n_b = n_pad // g
    n_tails, n_rows, max_t, n_cats = list_layout(n_pad, tile_i, tile_j, tail_tiles)
    f = flags.reshape(-1).tolist()
    win = (1 << span) - 1

    def masks(row):  # the row's three masks as Python ints (bit b: block b)
        out = [0, 0, 0]
        for b, fl in enumerate(f[row * n_b:(row + 1) * n_b]):
            for k, hit in enumerate((fl > 0, fl & 2, fl & 4)):
                if hit:
                    out[k] |= 1 << b
        return out

    def next_active(act, pos):  # the first set bit at or past pos, or -1
        rest = act >> pos
        return pos + (rest & -rest).bit_length() - 1 if rest else -1

    def cover(row, act, zr, xr):  # yields (category, list row, j block, jmin)
        b = next_active(act, row)
        while b >= 0:
            s = min(b, n_b - span)
            width = ((act >> b) & win).bit_length() if n_tails else span
            if width < span:
                yield 4 + width - 1, 9 + 2 * (width - 1), b, -1
            else:
                needs_mask = (s * g < row * g + g or s * g + tile_j > n
                              or row * g + g > n or b > s)
                cat = 3 if needs_mask else (2 if (zr >> b) & win else (1 if (xr >> b) & win else 0))
                yield cat, 2 * cat, s, (b if b > s else 0) if cat == 3 else -1
            b = next_active(act, b + span)

    row_masks = [masks(row) for row in range(n_b)]
    counts = []
    for row in range(n_b):
        cnt = [0] * n_cats
        for cat, *_ in cover(row, *row_masks[row]):
            cnt[cat] += 1
        counts.append(cnt)
    offs, totals = _scan_rows(counts)
    tiles = [[0] * max_t for _ in range(n_rows)]
    for row in range(n_b):
        pos = list(offs[row])
        for cat, list_row, j_blk, jmin in cover(row, *row_masks[row]):
            k = pos[cat]
            tiles[list_row][k], tiles[list_row + 1][k] = row, j_blk
            if jmin >= 0:
                tiles[8][k] = jmin
            pos[cat] += 1
    dev = flags.device
    return (torch.tensor(tiles, dtype=torch.int32, device=dev),
            torch.tensor(totals, dtype=torch.int32, device=dev))


@functools.lru_cache(maxsize=1)
def _pack_max_rows() -> int:
    """The pack kernel's largest n_b, asked of the library once."""
    return _cuda.library().ljmd_pack_max_rows()


def build_window_lists(flags: torch.Tensor, n: int, n_pad: int, tile_i: int,
                       tile_j: int, zero_fill: bool = False, tail_tiles: bool = True):
    """Visit lists (tiles, tcounts) of the (n_i * n_b,) block flags (flags at
    ``tile_i`` x ``tile_i`` granularity), or of each replica's of (R, n_i *
    n_b) flags ((R, rows, max_t) lists, (R, n_cats) counts). One kernel
    launch on a CUDA tensor, the only device operation with
    ``zero_fill=False``; the counts stay on the device. ``zero_fill`` zeroes
    the kernel's entries past the counts (the twin's are always zero)."""
    replicas = flags.dim() == 2
    if flags.device.type == "cpu":
        if replicas:
            lists = [build_window_lists_plain(f, n, n_pad, tile_i, tile_j, tail_tiles)
                     for f in flags]
            return tuple(torch.stack(x) for x in zip(*lists))
        return build_window_lists_plain(flags, n, n_pad, tile_i, tile_j, tail_tiles)
    if flags.device.type != "cuda":
        raise ValueError(f"build_window_lists: unsupported device {flags.device}")
    _check_geometry(n, n_pad, tile_i, tile_j)
    n_b = n_pad // tile_i
    batch = tuple(flags.shape[:1]) if replicas else ()
    if flags.dtype != torch.int32 or flags.shape[len(batch):] != (n_b * n_b,) \
            or (replicas and flags.shape[0] < 1):
        raise ValueError(f"build_window_lists: expected ({n_b * n_b},) or (R, {n_b * n_b}) "
                         f"int32 flags, got {tuple(flags.shape)} {flags.dtype}")
    if n_b > _pack_max_rows():
        raise ValueError(f"build_window_lists: {n_b} block rows > the kernel's "
                         f"{_pack_max_rows()}")
    n_tails, n_rows, max_t, n_cats = list_layout(n_pad, tile_i, tile_j, tail_tiles)
    flags = flags.contiguous()
    alloc = torch.zeros if zero_fill else torch.empty
    tiles = alloc(batch + (n_rows, max_t), dtype=torch.int32, device=flags.device)
    tcounts = torch.empty(batch + (n_cats,), dtype=torch.int32, device=flags.device)
    name = "build_window_lists_replicas" if replicas else "build_window_lists"
    with torch.cuda.device(flags.device):
        code = _cuda.library().ljmd_pack_window_lists(
            flags.data_ptr(), tiles.data_ptr(), tcounts.data_ptr(),
            n, n_b, tile_i, tile_j, n_tails, max_t, batch[0] if replicas else 0,
            _cuda.stream_handle(flags))
    _cuda.LAUNCHES.bump(name)
    _cuda.check(code, name)
    return tiles, tcounts
