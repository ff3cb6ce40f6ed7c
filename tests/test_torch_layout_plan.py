"""The launch plans of kernels 17 and 18 (``csrc/mosaic_probes.cu``,
``csrc/layout_bodies.cu``), written as plain Python beside their wrappers,
checked on the CPU: every probe output and every (visit, i row, column) of a
body is taken exactly once, and no work item lies past the grid.

Kernel 18's warps take 32 x 32 sub-tiles (``layout_items``); within one, lane
l pairs row l with column (l + k) mod 32 at step k, and carries the column
sums in registers that rotate only on steps with a hit. The schedule and
that rotation are replayed here in numpy against direct sums. Also: k5c's
plain version with a non-zero masked count (``cnt_ref[1]``) against the
Pallas body in interpret mode (the experiment itself keeps 0), rtol 1e-5 as
in ``test_torch_layout.py``; and the two CUDA sources' headers.
"""

import collections
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ljmd_tpu_torch.experiments import layout as ly
from ljmd_tpu_torch.experiments import mosaic_support as ms

REPO = os.path.join(os.path.dirname(__file__), "..")
CSRC = os.path.join(REPO, "ljmd_tpu_torch", "csrc")


# ---------------------------------------------------------------- kernel 18
@pytest.mark.parametrize("cap", [1, 7, 528])
@pytest.mark.parametrize("tj_w", [128, 512])
@pytest.mark.parametrize("v", [1, 31, 32, 128])
@pytest.mark.parametrize("name", ["k1", "k2", "k4", "k5b", "k5c", "k6"])
def test_layout_plan_covers_every_subtile_once(name, v, tj_w, cap):
    masked = v // 2 + 1 if name == "k5c" else 0
    plan = ly.layout_plan(name, v, tj_w, cap, masked)
    assert 1 <= plan["blocks"] <= cap and plan["warps"] == plan["blocks"] * ly.LAYOUT_WARPS
    items = ly.layout_items(plan)
    assert all(0 <= w < plan["warps"] for w, *_ in items)
    seen = collections.Counter((p, t, g, s) for _, p, t, g, s in items)
    n_sl = tj_w // ly.SUB
    _, _, dual, _, tail, second, pure = ly.VARIANTS[name]
    counts = (v, masked) if second else (v,)
    want = set()
    for p, cnt in enumerate(counts):
        n = 2 * (cnt // 2) if dual else cnt
        if tail and cnt % 2:
            n = cnt
        want |= {(p, t, g, s) for t in range(n) for g in range(4) for s in range(n_sl)}
    assert set(seen) == want and all(c == 1 for c in seen.values())
    if pure:  # a warp walks its sub-tile's visits in order, one flush an item
        assert plan["n_vc"] == max(1, min(v, cap * ly.LAYOUT_WARPS // (4 * n_sl)))
    # (visit, row, column) from the sub-tiles and the schedule below
    rows = {32 * g + l for g in range(4) for l in range(32)}
    cols = {32 * s + (l + k) % 32 for s in range(n_sl) for l in range(32) for k in range(32)}
    assert rows == set(range(128)) and cols == set(range(tj_w))


def test_subtile_schedule_pairs_each_row_and_column_once():
    pairs = collections.Counter((l, (l + k) % 32) for k in range(32) for l in range(32))
    assert len(pairs) == 32 * 32 and set(pairs.values()) == {1}
    for k in range(32):  # one owner a column a step
        assert sorted((l + k) % 32 for l in range(32)) == list(range(32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotated_column_sums_equal_direct_sums(seed):
    """The kernel's column sums: lane l holds column (l + ko) mod 32's sum,
    rotated to step k's owner by one indexed shuffle on a step with a hit,
    back to column l at the end; jmask rotates each step's ballot by k."""
    rng = np.random.default_rng(seed)
    force = rng.normal(size=(32, 32)).astype(np.float32)    # [step k, lane l]
    hit = rng.random((32, 32)) < (0.05, 0.5, 0.9)[seed]
    fj = np.zeros(32, np.float32)
    ko, jmask = 0, 0
    for k in range(32):
        ball = sum(1 << l for l in range(32) if hit[k, l])
        if not ball:
            continue
        fj = fj[[(l + k - ko) % 32 for l in range(32)]]      # __shfl_sync(fj, src)
        ko = k
        fj = np.where(hit[k], fj + force[k], fj)
        jmask |= ((ball << k) | (ball >> (32 - k))) & 0xFFFFFFFF
    fj = fj[[(l - ko) % 32 for l in range(32)]]
    want = np.zeros(32, np.float32)
    for k in range(32):
        for l in range(32):
            if hit[k, l]:
                want[(l + k) % 32] += force[k, l]
    np.testing.assert_allclose(fj, want, rtol=1e-6, atol=1e-6)
    assert jmask == sum(1 << m for m in {(l + k) % 32 for k in range(32) for l in range(32)
                                         if hit[k, l]})


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("exp_layout_plan_under_test",
                                                  os.path.join(REPO, "scripts", "exp_layout.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("v,masked", [(8, 7), (8, 8)])
def test_k5c_masked_count_matches_pallas(script, monkeypatch, v, masked):
    n_pad, steps, box, tj_w = 1024, 2, 5.0, 512
    for k, val in (("N_PAD", n_pad), ("STEPS", steps), ("OUTER", 1), ("L", box)):
        monkeypatch.setattr(script, k, val)
    r8, rT = ly.make_state(0, n_pad, box=box)
    # seed 3: visits 5 and 7 have their columns above their rows, so the
    # masked loop (gj > gi) has pairs to take
    ti, tj = ly.variant_lists("k5c", tj_w, *ly.visit_lists(v, 3, n_pad), n_pad)
    got = ly.layout_body_plain("k5c", r8, rT, ti, tj, v, tj_w, steps, box=box, masked=masked)
    cnt = jnp.array([v, masked], dtype=jnp.int32)
    jti, jtj = (jnp.asarray(np.asarray(x, dtype=np.int32)) for x in (ti, tj))
    with pltpu.force_tpu_interpret_mode(pltpu.InterpretParams(uninitialized_memory="zero")):
        # run_k5 with the counts [v, masked] (the script fixes [v, 0])
        kern = functools.partial(script.k5_kernel, tj_w=tj_w, tail=True, second_loop=True)
        f = pl.pallas_call(
            kern, in_specs=[script.smem(), script.smem(), script.smem(), script.vmem()],
            out_specs=script.vmem(), out_shape=jax.ShapeDtypeStruct((8, n_pad), jnp.float32),
            scratch_shapes=[pltpu.VMEM((8, n_pad), jnp.float32),
                            pltpu.VMEM((8, n_pad), jnp.float32)])
        g, args = script.chain(f, (cnt, jti, jtj, jnp.asarray(r8.numpy())), r_index=3)
        want = np.asarray(jax.block_until_ready(g(*args)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # the masked loop changed the forces: its visits count
    plain0 = ly.layout_body_plain("k5c", r8, rT, ti, tj, v, tj_w, steps, box=box)
    assert np.abs(got[1].numpy() - plain0[1].numpy()).max() > 0


# ---------------------------------------------------------------- kernel 17
def _touched(name: str, n: int) -> set:
    """The flat output elements the probe writes (the rest stay the
    wrapper's zeros)."""
    x = ms.probe_inputs(name, "cpu", n=n, iters=1)[-1]
    size = int(np.prod(ms._out_shape(name, x, n)))
    if name.startswith("lane"):
        return set(range(512))
    if name == "rowsum_store":
        return {(s * 128 + r) * 8 for s in range(32) for r in range(128)}
    return set(range(size))


@pytest.mark.parametrize("n", [4096, 8192])
@pytest.mark.parametrize("name", [p for p, _ in ms.PROBES])
def test_probe_plan_writes_every_output_once(name, n):
    x = ms.probe_inputs(name, "cpu", n=n, iters=1)[-1]
    plan = ms.probe_plan(name, tuple(x.shape))
    out = ms.plan_outputs(plan)
    assert len(out) == len(set(out)) and set(out) == _touched(name, n)
    if plan["kind"] == "gather":  # the staged slice holds every element read
        assert plan["len"] == (x.shape[0] if name.startswith("sublane") else x.shape[1])


@pytest.mark.parametrize("shape", [(8, 4096), (4096, 8), (128, 128), (4, 100), (12, 40),
                                   (36, 9), (8, 8), (100, 3)])
def test_transpose_plan_writes_every_output_once(shape):
    plan = ms.transpose_plan(*shape)
    (tr, tc), pad = plan["tile"], plan["pad"]
    assert tr % 4 == 0 and plan["threads"] <= 64 and tr * (tc + pad) <= 288
    out = ms.plan_outputs(plan)
    assert len(out) == len(set(out)) == shape[0] * shape[1]
    assert set(out) == set(range(shape[0] * shape[1]))


def test_transpose_plan_refuses_rows_off_four():
    with pytest.raises(ValueError):
        ms.transpose_plan(6, 32)


# ---------------------------------------------------------------- the sources
@pytest.mark.parametrize("name", ["mosaic_probes.cu", "layout_bodies.cu"])
def test_experiment_kernel_headers(name):
    head = open(os.path.join(CSRC, name)).read()[:1500]
    assert "Replaces: scripts/exp_" in head
    assert "What bounds it on the H100" in head and "What the design does" in head
