"""Per-visit cost of the pair-tile body variants on the card (the port's
``scripts/exp_layout.py``), as differential slopes: each body runs STEPS
steps over a list of 32 and of 128 random (i-tile, j-tile) visits in one
launch (``csrc/layout_bodies.cu``, kernel 18), chained OUTER times, and the
time difference over (128 - 32) * STEPS * OUTER visits is the cost of one
visit. The launch and the chaining cancel in the slope.

The bodies (module docstring of ``csrc/layout_bodies.cu``): k1 (rows
layout), k2b (transposed i positions and i sums), k2 (transposed tile, j rows
at 8-granular offsets), k3 (k2b, 2-way unroll, dual accumulators), k4 (k1
the same), k4z (k4 without the z minimum image), k5a/b/c (k4 with a visit
count read on the device, an odd tail, a zero-trip masked second loop), k6
(pair math, no reductions); and the glue probes: a transpose of (8, N_PAD)
and (N_PAD, 8), and the (N_PAD, 8) -> (8, N_PAD) "dot transpose" (a
transpose here: the TPU did it on its matrix unit).

Two choices differ from the JAX script and change no cost: the positions are
a jittered cubic lattice in the box (uniform random ones put pairs at r ~ 0.05
and forces near float32's range), and no visit's j columns overlap its i rows
(a particle against itself gives r^2 = 0 and NaN forces in the TPU bodies).

Usage: python -m ljmd_tpu_torch.experiments.layout [--device cuda|cpu] [k1-512 k2b-512 ...]
"""

from __future__ import annotations

import ctypes
import functools
import math
import statistics
import sys

import numpy as np
import torch

from ljmd_tpu_torch.experiments._common import device_line, elapsed_s, parser
from ljmd_tpu_torch.experiments.mosaic_support import transpose_scaled
from ljmd_tpu_torch.models.forces import resolve_device
from ljmd_tpu_torch.ops import _cuda
from ljmd_tpu_torch.ops.pair_terms import lj_pair_terms_plain

N_PAD = 4096
L = 16.796
RC2 = 6.25
# STEPS * OUTER sets the differential signal: (128 - 32) * STEPS * OUTER
# visit executions.
STEPS = 50
OUTER = 20
V_LO, V_HI = 32, 128
ITERS_LO, ITERS_HI = 64, 512  # the transpose probes, not chained
REPS = 5
# The kernel's launch shape (csrc/layout_bodies.cu): warps a block, and the
# rows and columns of a warp's sub-tile.
LAYOUT_WARPS, SUB = 8, 32
DEFAULT = ("k1-512", "k2b-512", "k2-512", "k3-512", "k1-128", "k2b-128", "k2-128", "trans",
           "dot")

# Body -> (kernel index in csrc/layout_bodies.cu, layout, dual accumulators,
# z minimum image, odd tail, masked second loop, pure). The kernel reads k5's
# counts on the device; the plain version needs no switch for that.
VARIANTS = {
    "k1": (0, 0, False, True, False, False, False),
    "k2b": (1, 1, False, True, False, False, False),
    "k2": (2, 2, False, True, False, False, False),
    "k3": (3, 1, True, True, False, False, False),
    "k4": (4, 0, True, True, False, False, False),
    "k4z": (5, 0, True, False, False, False, False),
    "k5a": (6, 0, True, True, False, False, False),
    "k5b": (7, 0, True, True, True, False, False),
    "k5c": (8, 0, True, True, True, True, False),
    "k6": (9, 0, False, True, False, False, True),
}


def make_state(seed: int = 0, n_pad: int | None = None, device="cpu", box: float | None = None):
    """(r8 (8, n_pad), rT (n_pad, 8)) float32: n_pad points of a jittered
    cubic lattice filling the box (a random subset of its sites)."""
    n_pad = N_PAD if n_pad is None else n_pad
    box = L if box is None else box
    rng = np.random.default_rng(seed)
    m = math.ceil(n_pad ** (1.0 / 3.0) - 1e-9)
    sites = np.stack(np.meshgrid(*(np.arange(m),) * 3, indexing="ij"), -1).reshape(-1, 3)
    sites = sites[rng.permutation(len(sites))[:n_pad]]
    r = ((sites + 0.5 + rng.normal(0.0, 0.05, sites.shape)) * (box / m)) % box
    r8 = torch.zeros((8, n_pad), dtype=torch.float32)
    r8[0:3] = torch.as_tensor(r.T, dtype=torch.float32)
    rT = torch.zeros((n_pad, 8), dtype=torch.float32)
    rT[:, 0:3] = r8[0:3].T
    return r8.to(device), rT.to(device)


def _k2_rows(tj: int, n_pad: int, tj_w: int) -> int:
    """k2's j start row (the JAX script's (tj * 37) % ((N_PAD - tj_w) // 8), x 8)."""
    return 8 * ((tj * 37) % ((n_pad - tj_w) // 8))


def _overlaps(ti: int, tj: int, n_pad: int) -> bool:
    """Whether the i rows [128 ti, 128 ti + 128) meet the j columns of the
    visit under any of the script's tilings (512 and 128 columns; k2's
    rows at either width)."""
    i_lo = 128 * ti
    for tj_w in (512, 128):
        j_lo = (tj % (n_pad // tj_w)) * tj_w
        if j_lo < i_lo + 128 and i_lo < j_lo + tj_w:
            return True
        j_lo = _k2_rows(tj % (n_pad // tj_w), n_pad, tj_w)
        if j_lo < i_lo + 128 and i_lo < j_lo + tj_w:
            return True
    return False


def visit_lists(v: int, seed: int = 7, n_pad: int | None = None) -> tuple[list, list]:
    """v random (i tile, j tile at 512 columns) visits whose columns never
    meet their rows."""
    n_pad = N_PAD if n_pad is None else n_pad
    rng = np.random.default_rng(seed)
    ti, tj = [], []
    while len(ti) < v:
        a, b = int(rng.integers(0, n_pad // 128)), int(rng.integers(0, n_pad // 512))
        if not _overlaps(a, b, n_pad):
            ti.append(a)
            tj.append(b)
    return ti, tj


def variant_lists(name: str, tj_w: int, ti: list, tj: list, n_pad: int) -> tuple[list, list]:
    """The j list a variant takes at width tj_w (the JAX main's mapping)."""
    if name == "k2":
        return ti, [_k2_rows(t, n_pad, tj_w) // 8 for t in tj]
    return ti, [t % (n_pad // tj_w) for t in tj]


def _tile_terms(xi, xj, box, rc2, mic_z, mask_fn=None):
    """(d (3, a, b) = xi - xj minimum image, coef) of the (3, a) against
    (3, b) positions."""
    d = xi[:, :, None] - xj[:, None, :]
    inv = 1.0 / box
    for c in range(3 if mic_z else 2):
        d[c] = d[c] - box * torch.round(d[c] * inv)
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    mask = r2 < rc2
    if mask_fn is not None:
        mask &= mask_fn
    return d, lj_pair_terms_plain(r2, mask, want_observables=False)[0]


def layout_body_plain(name: str, r, rT, ti, tj, v: int, tj_w: int, steps: int,
                      box: float = L, rc2: float = RC2, masked: int = 0) -> torch.Tensor:
    """The body's plain PyTorch version: the TPU body's arithmetic, visit
    by visit. Returns r after ``steps`` steps. ``masked`` is k5c's second
    count (``cnt_ref[1]``: its masked loop's visits, 0 in the experiment)."""
    _, layout, dual, mic_z, tail, second, pure = VARIANTS[name]
    r = r.clone()
    n_pad = r.shape[1]
    ti, tj = [int(t) for t in ti], [int(t) for t in tj]
    counts = (v, masked)
    for _ in range(steps):
        r[0] += 1e-6
        f = [torch.zeros_like(r), torch.zeros_like(r)]
        fT = [torch.zeros_like(rT), torch.zeros_like(rT)]
        acc = torch.zeros((128, n_pad), dtype=r.dtype, device=r.device)
        for pass_ in (0, 1) if second else (0,):
            cnt = counts[pass_]
            n_work = 2 * (cnt // 2) if dual else cnt
            if tail and cnt % 2:
                n_work = cnt
            for t in range(n_work):
                k = t & 1 if dual else 0
                i_lo = ti[t] * 128
                isl = slice(i_lo, i_lo + 128)
                if layout == 2:
                    j_lo = tj[t] * 8
                    jsl = slice(j_lo, j_lo + tj_w)
                    d, coef = _tile_terms(rT[jsl, 0:3].T, r[0:3, isl], box, rc2, mic_z)
                    fd = coef[None] * d                              # (3, tj_w, 128)
                    f[k][0:3, isl] -= fd.sum(dim=1)
                    fT[k][jsl, 0:3] += fd.sum(dim=2).T
                    continue
                j_lo = tj[t] * tj_w
                jsl = slice(j_lo, j_lo + tj_w)
                xi = rT[isl, 0:3].T if layout == 1 else r[0:3, isl]
                gmask = None
                if pass_ == 1:
                    gi = torch.arange(i_lo, i_lo + 128, device=r.device)[:, None]
                    gj = torch.arange(j_lo, j_lo + tj_w, device=r.device)[None, :]
                    gmask = (gj > gi) & (gj < n_pad) & (gi < n_pad)
                d, coef = _tile_terms(xi, r[0:3, jsl], box, rc2, mic_z, gmask)
                if pure:
                    acc[:, 0:tj_w] += coef * d[0] + coef * d[1] + coef * d[2]
                    continue
                fd = coef[None] * d                                  # (3, 128, tj_w)
                if layout == 1:
                    fT[k][isl, 0:3] += fd.sum(dim=2).T
                else:
                    f[k][0:3, isl] += fd.sum(dim=2)
                f[k][0:3, jsl] -= fd.sum(dim=1)
        if pure:
            fy = acc[1]
        else:
            fy = f[0][1] + f[1][1] if dual else f[0][1]
        r[1] += fy * 1e-9
        if layout == 1 and dual:
            r[2] += (fT[0][0, 0] + fT[1][0, 0]) * 0.0
    return r


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int, kernel: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _cuda.check(_cuda.library().ljmd_layout_max_blocks(kernel, ctypes.byref(out)),
                    "layout_body occupancy query")
    return out.value


def _n_work(cnt: int, dual: bool, tail: bool) -> int:
    """Visits a pass runs: pairs of visits with dual accumulators, plus the
    odd tail visit where the body has one."""
    n = 2 * (cnt // 2) if dual else cnt
    return cnt if tail and cnt % 2 else n


def layout_plan(name: str, v: int, tj_w: int, cap: int, masked: int = 0) -> dict:
    """The body's launch plan (``csrc/layout_bodies.cu``) on a card that
    holds ``cap`` blocks at once: warp items are 32 x 32 sub-tiles of a
    visit (``layout_items``), blocks of LAYOUT_WARPS warps, as many blocks
    as the items fill, at most ``cap``. PURE splits the visits into n_vc
    chunks, each warp item one (g, s) sub-tile over a chunk."""
    _, _, dual, _, tail, second, pure = VARIANTS[name]
    n_sl = tj_w // SUB
    if pure:
        groups = 4 * n_sl
        n_vc = max(1, min(v, cap * LAYOUT_WARPS // groups))
        works = [v]
        items = groups * n_vc if v > 0 else 0
    else:
        n_vc = 0
        works = [_n_work(v, dual, tail)] + ([_n_work(masked, dual, tail)] if second else [])
        items = sum(works) * 4 * n_sl
    blocks = max(1, min(cap, -(-items // LAYOUT_WARPS)))
    return {"name": name, "v": v, "tj_w": tj_w, "n_sl": n_sl, "n_vc": n_vc, "works": works,
            "items": items, "blocks": blocks, "warps": blocks * LAYOUT_WARPS, "pure": pure}


def layout_items(plan: dict) -> list[tuple]:
    """Each warp's sub-tiles in the kernel's order: (warp, pass, visit, i
    group g, column slice s). The sub-tile's rows are 32 g .. 32 g + 31 of
    the visit's i tile, its columns 32 s .. 32 s + 31 of its j range; at step
    k lane l pairs row 32 g + l with column 32 s + (l + k) mod 32."""
    out = []
    n_sl, nw = plan["n_sl"], plan["warps"]
    if plan["pure"]:
        groups, v = 4 * n_sl, plan["v"]
        for gw in range(nw):
            for w in range(gw, plan["items"], nw):
                grp = w % groups
                out += [(gw, 0, t, grp % 4, grp // 4)
                        for t in range(w // groups, v, plan["n_vc"])]
        return out
    items0 = plan["works"][0] * 4 * n_sl
    for gw in range(nw):
        for it in range(gw, plan["items"], nw):
            pass_ = int(it >= items0)
            local = it - (items0 if pass_ else 0)
            out.append((gw, pass_, local // (4 * n_sl), local % 4, (local // 4) % n_sl))
    return out


def layout_body(name: str, r, rT, ti, tj, v: int, tj_w: int, steps: int,
                box: float = L, rc2: float = RC2, masked: int = 0) -> torch.Tensor:
    """One launch of the body on CUDA tensors (``ti``/``tj`` int32 on the
    card), the plain version on CPU tensors. Returns r after ``steps``.
    ``masked``: k5c's masked-loop count, read on the device."""
    if r.device.type == "cpu":
        return layout_body_plain(name, r, rT, ti, tj, v, tj_w, steps, box, rc2, masked)
    kernel, _, _, _, _, _, pure = VARIANTS[name]
    n_pad = r.shape[1]
    if r.device.type != "cuda" or r.dtype != torch.float32 or r.shape != (8, n_pad) \
            or rT.shape != (n_pad, 8) or rT.device != r.device or rT.dtype != r.dtype \
            or not (r.is_contiguous() and rT.is_contiguous()):
        raise ValueError(f"layout_body {name}: r (8, n) and rT (n, 8) contiguous float32 "
                         "on one CUDA device")
    if n_pad % 128 or tj_w % 128 or tj_w > n_pad:
        raise ValueError(f"layout_body {name}: n_pad={n_pad} and tj_w={tj_w} must be "
                         "multiples of 128, tj_w <= n_pad")
    for t in (ti, tj):
        if t.device != r.device or t.dtype != torch.int32 or t.numel() < max(v, masked) \
                or masked < 0:
            raise ValueError(f"layout_body {name}: ti / tj must be >= {max(v, masked)} int32 "
                             f"on {r.device}, masked >= 0")
    dev = r.device
    r_out = r.clone()
    # The kernel zeroes what it reads of f, f2, fT, fT2 every step; PURE's
    # acc only its first tj_w columns, and reads row 1 to n_pad.
    f, f2 = torch.empty_like(r), torch.empty_like(r)
    fT, fT2 = torch.empty_like(rT), torch.empty_like(rT)
    acc = (torch.zeros((128, n_pad), dtype=r.dtype, device=dev) if pure
           else torch.empty((1,), dtype=r.dtype, device=dev))
    # The device counts by fills (no host copy: a call can be captured in a
    # CUDA graph).
    cnt = torch.full((2,), v, dtype=torch.int32, device=dev)
    cnt[1:].fill_(masked)
    plan = layout_plan(name, v, tj_w, _max_blocks(dev.index, kernel), masked)
    with torch.cuda.device(dev):
        code = _cuda.library().ljmd_layout_body(
            kernel, r_out.data_ptr(), rT.data_ptr(), f.data_ptr(), f2.data_ptr(),
            fT.data_ptr(), fT2.data_ptr(), acc.data_ptr(), ti.data_ptr(), tj.data_ptr(),
            cnt.data_ptr(), v, n_pad, tj_w, steps, float(box), 1.0 / float(box), float(rc2),
            plan["n_vc"], plan["blocks"], _cuda.stream_handle(r))
    _cuda.LAUNCHES.bump("layout_bodies")
    _cuda.check(code, f"layout_body {name}")
    return r_out


def chained(name, r8, rT, ti, tj, v, tj_w, outer=None, steps=None):
    """OUTER calls of the body, each from the last one's r."""
    outer = OUTER if outer is None else outer
    steps = STEPS if steps is None else steps
    r = r8
    for _ in range(outer):
        r = layout_body(name, r, rT, ti, tj, v, tj_w, steps)
    return r


def diff(fa, fb, scale: float, label: str, device, reps: int | None = None) -> float:
    """Per-unit slope between two runs that differ by ``scale`` units:
    the median over ``reps`` of (t_b - t_a) / scale, a and b in turns."""
    reps = REPS if reps is None else reps
    fa()
    fb()
    slopes = []
    for _ in range(reps):
        t_a = elapsed_s(fa, device)
        slopes.append((elapsed_s(fb, device) - t_a) / scale)
    s = statistics.median(slopes)
    print(f"{label:44s}: {s*1e9:9.1f} ns/unit", flush=True)
    return s


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("which", nargs="*", help="bodies as <name>-<tj_w>, 'trans', 'dot'")
    args = p.parse_args(argv)
    which = args.which or list(DEFAULT)
    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    r8, rT = make_state(0, N_PAD, device)
    ti, tj = visit_lists(V_HI, 7, N_PAD)
    scale = (V_HI - V_LO) * STEPS * OUTER
    labels = {"k1": "K1  current body   ({w} lanes j)", "k2b": "K2b transposed-acc ({w} lanes j)",
              "k2": "K2  transposed tile ({w} sub j)", "k3": "K3  K2b+unroll2+dualacc ({w})",
              "k4": "K4  K1+unroll2+dualacc ({w})", "k4z": "K4z K4 without z-MIC ({w})",
              "k5a": "K5a K4+dynamic trip      ({w})", "k5b": "K5b K5a+pl.when tail     ({w})",
              "k5c": "K5c K5b+masked loop body ({w})", "k6": "K6  pure-math ceiling    ({w})"}
    out = {}
    for item in which:
        if item in ("trans", "dot"):
            continue
        name, w = item.rsplit("-", 1)
        tj_w = int(w)
        ti_v, tj_v = variant_lists(name, tj_w, ti, tj, N_PAD)
        lists = [torch.tensor(x, dtype=torch.int32, device=device) for x in (ti_v, tj_v)]
        out[item] = diff(lambda: chained(name, r8, rT, *lists, V_LO, tj_w),
                         lambda: chained(name, r8, rT, *lists, V_HI, tj_w),
                         scale, labels[name].format(w=tj_w), device)
    if "trans" in which:
        for shape in ((8, N_PAD), (N_PAD, 8)):
            x = torch.ones(shape, dtype=torch.float32, device=device)
            out[f"trans {shape}"] = diff(lambda: transpose_scaled(x, ITERS_LO),  # noqa: B023
                                         lambda: transpose_scaled(x, ITERS_HI),  # noqa: B023
                                         ITERS_HI - ITERS_LO, f"jnp.transpose {shape}", device)
    if "dot" in which:
        x = torch.ones((N_PAD, 8), dtype=torch.float32, device=device)
        out["dot"] = diff(lambda: transpose_scaled(x, ITERS_LO),
                          lambda: transpose_scaled(x, ITERS_HI), ITERS_HI - ITERS_LO,
                          "dot-transpose (N,8)->(8,N) chunked", device)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
