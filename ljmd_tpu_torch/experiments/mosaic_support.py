"""Which layout operations cost what on the card: the nine probes of
``scripts/exp_mosaic_support.py`` as CUDA kernels (``csrc/mosaic_probes.cu``,
kernel 17), each an ITERS-long loop in one launch, float32:

  t8n / t128        transpose (8, N) -> (N, 8) and (128, 128), plus the
                    iteration counter;
  lane_unaligned /  a 512-lane window of row 0 of an (8, N) matrix at a
  lane_aligned      runtime offset (any, or a multiple of 128) added into
                    row 0 of an (8, 512) output;
  sublane8 /        a 256-row window of an (N, 128) matrix at a runtime offset
  sublane_any       (a multiple of 8, or any) added into a (256, 128) output;
  roll              roll (8, 512) on lanes by a runtime shift, added up;
  rowsum            row sums of (128, 512) * (1 + i) into a register;
  rowsum_store      the same, added each iteration into the (i % 32)-th
                    128-row block of column 0 of an (N, 8) output.

The TPU probes accumulate into outputs they never initialise; here those
outputs start at zero (the tests run the TPU probes with zero-initialised
memory). Each probe has its plain PyTorch version (``probe_plain``); the
smoke script times each beside the library call it stands for
(``.t().contiguous()``, a slice ``+=``, ``torch.roll`` or ``torch.sum``).

Usage: python -m ljmd_tpu_torch.experiments.mosaic_support [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import torch

from ljmd_tpu_torch.experiments._common import best_of, device_line, parser
from ljmd_tpu_torch.models.forces import resolve_device
from ljmd_tpu_torch.ops import _cuda

N = 4096
ITERS = 200  # loop iterations inside the kernel to expose per-op cost
REPS = 3
GATHER_THREADS = 128  # threads a window / roll block (csrc/mosaic_probes.cu)

# (name, label as the JAX script prints it)
PROBES = (
    ("t8n", "transpose (8,4096)->(4096,8)"),
    ("t128", "transpose (128,128)"),
    ("lane_unaligned", "lane ds unaligned (512 from 4096)"),
    ("lane_aligned", "lane ds 128-aligned (control)"),
    ("sublane8", "sublane ds 8-aligned (256,128)"),
    ("sublane_any", "sublane ds any-offset (256,128)"),
    ("roll", "pltpu.roll dynamic lanes (8,512)"),
    ("rowsum", "rowsum(128,512)->reg(128,1)"),
    ("rowsum_store", "rowsum + sublane store (N,8)"),
)
# The window probes: (lane or sublane window, offset scale).
WINDOWS = {"lane_unaligned": ("lane", 1), "lane_aligned": ("lane", 128),
            "sublane8": ("sublane", 8), "sublane_any": ("sublane", 1)}


def probe_inputs(name: str, device, n: int | None = None, iters: int | None = None) -> tuple:
    """The probe's inputs, as the script's build_* functions make them: (x,) or (offs, x)."""
    n = N if n is None else n
    iters = ITERS if iters is None else iters
    f32 = torch.float32
    it = torch.arange(iters, dtype=torch.int32)
    if name == "t8n" or name.startswith("lane"):
        x = torch.arange(8 * n, dtype=f32).reshape(8, n) * 1e-6
    elif name == "t128":
        x = torch.arange(128 * 128, dtype=f32).reshape(128, 128) * 1e-6
    elif name.startswith("sublane"):
        x = torch.arange(n * 128, dtype=f32).reshape(n, 128) * 1e-7
    elif name == "roll":
        x = torch.arange(8 * 512, dtype=f32).reshape(8, 512) * 1e-6
    else:
        x = torch.ones((128, 512), dtype=f32)
    offs = {"lane_unaligned": (it * 37) % (n - 512),
            "lane_aligned": (it * 7) % ((n - 512) // 128),
            "sublane8": (it * 5) % ((n - 256) // 8),
            "sublane_any": (it * 37) % (n - 256),
            "roll": (it * 37) % 512}.get(name)
    x = x.to(device)
    return (x,) if offs is None else (offs.to(device), x)


def _out_shape(name: str, x: torch.Tensor, n: int) -> tuple:
    if name in ("t8n", "t128"):
        return (x.shape[1], x.shape[0])
    if name.startswith("lane") or name == "roll":
        return (8, 512)
    if name.startswith("sublane"):
        return (256, 128)
    return (128, 1) if name == "rowsum" else (n, 8)


def probe_plain(name: str, *inputs, iters: int | None = None, n: int | None = None) -> torch.Tensor:
    """The probe's plain PyTorch version: the same loop, op by op."""
    iters = ITERS if iters is None else iters
    n = N if n is None else n
    x = inputs[-1]
    out = torch.zeros(_out_shape(name, x, n), dtype=x.dtype, device=x.device)
    offs = inputs[0].tolist() if len(inputs) == 2 else None
    for i in range(iters):
        if name in ("t8n", "t128"):
            out = x.t() + float(i)
        elif name in WINDOWS:
            kind, scale = WINDOWS[name]
            o = offs[i] * scale
            if kind == "lane":
                out[0] += x[0, o:o + 512]
            else:
                out += x[o:o + 256]
        elif name == "roll":
            out += torch.roll(x, offs[i], 1)
        else:
            s = torch.sum(x * (1.0 + i), dim=1, keepdim=True)
            if name == "rowsum":
                out = out + s
            else:
                out[(i % 32) * 128:(i % 32) * 128 + 128, 0:1] += s
    return out.contiguous()


def transpose_plan(rows: int, cols: int) -> dict:
    """The transpose kernel's launch plan for an (rows, cols) input (rows a
    multiple of 4): a block holds a tr x tc tile of x, padded to tc + pad
    floats a row, and thread t = oc * (tr // 4) + q writes output row c0 + oc,
    columns r0 + 4q .. r0 + 4q + 3 as one float4 (``csrc/mosaic_probes.cu``)."""
    if rows % 4 or rows < 1 or cols < 1:
        raise ValueError(f"transpose: rows={rows} must be a positive multiple of 4, cols >= 1")
    if rows <= 8:
        tr, tc, pad = rows, 32, 4
    elif cols <= 8:
        tr, tc, pad = 32, cols, 1
    else:
        tr, tc, pad = 16, 16, 2
    return {"kind": "transpose", "rows": rows, "cols": cols, "tile": (tr, tc), "pad": pad,
            "grid": (-(-cols // tc), -(-rows // tr)), "threads": tr * tc // 4}


def gather_plan(name: str, shape: tuple) -> dict:
    """The window / roll kernel's launch plan: block b takes slice b // n_jb
    (x and out offset sl * sl_stride, staged x[sl * sl_stride + k * ld] for
    k < len) and outputs j = (b % n_jb) * threads * ept + u * threads + t
    (u < ept, j < count), each at sl * sl_stride + j * ld."""
    rows, cols = shape
    # (slices, slice stride, element stride, staged length, outputs, scale,
    # outputs a thread)
    if name == "roll":
        n_sl, sl_stride, ld, length, count, scale, ept = rows, cols, 1, cols, cols, 1, 1
    elif WINDOWS[name][0] == "lane":
        n_sl, sl_stride, ld, length, count, ept = 1, 0, 1, cols, 512, 1
        scale = WINDOWS[name][1]
    else:
        n_sl, sl_stride, ld, length, count, ept = cols, 1, cols, rows, 256, 2
        scale = WINDOWS[name][1]
    n_jb = -(-count // (GATHER_THREADS * ept))
    return {"kind": "gather", "roll": name == "roll", "scale": scale, "n_sl": n_sl,
            "sl_stride": sl_stride, "ld": ld, "len": length, "count": count, "ept": ept,
            "n_jb": n_jb, "blocks": n_sl * n_jb, "threads": GATHER_THREADS}


def probe_plan(name: str, x_shape: tuple) -> dict:
    """The launch plan of probe ``name`` on an input of ``x_shape``."""
    if name in ("t8n", "t128"):
        return transpose_plan(*x_shape)
    if name in WINDOWS or name == "roll":
        return gather_plan(name, x_shape)
    return {"kind": "rowsum", "store": name == "rowsum_store", "rows": x_shape[0],
            "width": x_shape[1], "blocks": x_shape[0], "threads": 32}


def plan_outputs(plan: dict) -> list[int]:
    """The flat output indices each thread of the plan writes, in launch
    order (block, thread), as the kernel computes them."""
    out = []
    if plan["kind"] == "transpose":
        (tr, tc), rows, cols = plan["tile"], plan["rows"], plan["cols"]
        gx, gy = plan["grid"]
        for by in range(gy):
            for bx in range(gx):
                c0, r0 = bx * tc, by * tr
                for t in range(plan["threads"]):
                    oc, q = divmod(t, tr // 4)
                    if c0 + oc < cols and r0 + 4 * q < rows:
                        out += [(c0 + oc) * rows + r0 + 4 * q + k for k in range(4)]
    elif plan["kind"] == "gather":
        per_block = plan["threads"] * plan["ept"]
        for b in range(plan["blocks"]):
            sl, jb = divmod(b, plan["n_jb"])
            for t in range(plan["threads"]):
                for u in range(plan["ept"]):
                    j = jb * per_block + u * plan["threads"] + t
                    if j < plan["count"]:
                        out.append(sl * plan["sl_stride"] + j * plan["ld"])
    else:
        for r in range(plan["blocks"]):
            out += ([(s * plan["rows"] + r) * 8 for s in range(32)] if plan["store"] else [r])
    return out


def probe(name: str, *inputs, iters: int | None = None, n: int | None = None) -> torch.Tensor:
    """Run the probe: one kernel launch on a CUDA tensor, the plain version
    on a CPU tensor."""
    iters = ITERS if iters is None else iters
    n = N if n is None else n
    x = inputs[-1]
    if x.device.type == "cpu":
        return probe_plain(name, *inputs, iters=iters, n=n)
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous() \
            or x.dim() != 2 or iters < 1:
        raise ValueError(f"probe {name}: x must be 2-D contiguous float32 on a CUDA device, "
                         f"iters >= 1")
    if len(inputs) == 2:
        offs = inputs[0]
        if offs.device != x.device or offs.dtype != torch.int32 or offs.numel() < iters \
                or not offs.is_contiguous():
            raise ValueError(f"probe {name}: offs must be >= {iters} contiguous int32 on "
                             f"{x.device}")
    plan = probe_plan(name, tuple(x.shape))
    if (name.startswith("sublane") and x.shape[1] != 128) \
            or (name.startswith("lane") and x.shape[1] < 512) \
            or (plan["kind"] == "rowsum" and (x.shape[1] % 32 or x.shape[1] > 512
                                              or (plan["store"] and n < 32 * x.shape[0]))):
        raise ValueError(f"probe {name}: shape {tuple(x.shape)} (n={n}) is not the probe's")
    lib = _cuda.library()
    out = torch.zeros(_out_shape(name, x, n), dtype=x.dtype, device=x.device)
    stream = _cuda.stream_handle(x)
    with torch.cuda.device(x.device):
        if plan["kind"] == "transpose":
            code = lib.ljmd_probe_transpose(x.data_ptr(), out.data_ptr(), x.shape[0],
                                            x.shape[1], iters, 0, *plan["tile"], plan["pad"],
                                            stream)
        elif plan["kind"] == "gather":
            code = lib.ljmd_probe_gather(inputs[0].data_ptr(), x.data_ptr(), out.data_ptr(),
                                         iters, plan["scale"], int(plan["roll"]), plan["n_sl"],
                                         plan["sl_stride"], plan["ld"], plan["len"],
                                         plan["count"], plan["ept"], stream)
        else:
            code = lib.ljmd_probe_rowsum(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                                         iters, int(plan["store"]), stream)
    _cuda.LAUNCHES.bump("mosaic_probes")
    _cuda.check(code, f"probe {name}")
    return out


def transpose_scaled(x: torch.Tensor, iters: int) -> torch.Tensor:
    """x^T * (1 + 1e-9 (iters - 1)), rewritten ``iters`` times in one launch
    (``exp_layout.py``'s ``transpose_cost`` and ``dot_transpose_cost``; the
    count goes to ``layout_bodies``, whose row lists these glue probes)."""
    if x.device.type == "cpu":
        return transpose_scaled_plain(x, iters)
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous() \
            or x.dim() != 2 or iters < 1:
        raise ValueError("transpose_scaled: x must be 2-D contiguous float32 on a CUDA device, "
                         "iters >= 1")
    plan = transpose_plan(*x.shape)
    out = torch.empty((x.shape[1], x.shape[0]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = _cuda.library().ljmd_probe_transpose(x.data_ptr(), out.data_ptr(), x.shape[0],
                                                    x.shape[1], iters, 1, *plan["tile"],
                                                    plan["pad"], _cuda.stream_handle(x))
    _cuda.LAUNCHES.bump("layout_bodies")
    _cuda.check(code, "transpose_scaled")
    return out


def transpose_scaled_plain(x: torch.Tensor, iters: int) -> torch.Tensor:
    out = x.t().contiguous()
    for i in range(iters):
        # (1 + 1e-9 i) in float32, as the kernel and the TPU body round it
        scale = torch.tensor(1e-9, dtype=torch.float32) * torch.tensor(float(i)) + 1.0
        out = x.t() * scale.to(x.device)
    return out.contiguous()


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    out = {}
    for name, label in PROBES:
        inputs = probe_inputs(name, device)
        res = probe(name, *inputs)
        s = float(torch.sum(res))
        t = best_of(lambda: probe(name, *inputs), device, REPS)  # noqa: B023
        print(f"{label:45s}: OK   {t*1e3:8.3f} ms ({ITERS} iters) sum={s:.3e}", flush=True)
        out[name] = {"ms": 1e3 * t, "sum": s}
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
