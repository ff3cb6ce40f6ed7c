"""The cell-pair rebin's entry point (``ljmd_tpu_torch/ops/pencil_rebin.py``
``rebin_slots``) on the CPU, where it runs its plain twin:

- bit for bit the composition the engine ran before it (the wrap, then
  ``rebin_gather_parts``, the two gathers, ``sentinel_fill`` and the counts),
  for one system and an R=3 stack, plain and compensated rows (wrapped
  beforehand, the remainders carried), with and without the accelerations,
  on drifted slots with particles across the faces and a pencil past
  capacity;
- the folded drift check against the engine's ``_invalid_check`` formula,
  one replica's slot drifted past the threshold;
- no kernel counted on CPU tensors.

The card's kernels are held to this twin in tests/test_torch_cuda.py. The
geometry is tests/test_torch_cuda.py's ``_pencil_carry`` (N=2048, L=13.4,
4x4 pencils of capacity 256).
"""

import numpy as np
import pytest
import torch

from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models.lattice import fcc_lattice
from ljmd_tpu_torch.ops import pencil_rebin
from ljmd_tpu_torch.ops._cuda import LAUNCHES
from ljmd_tpu_torch.ops.cell_list import make_pencil_grid, rebin_gather_parts
from ljmd_tpu_torch.ops.fused import wrap_positions_ext
from ljmd_tpu_torch.ops.geometry import minimum_image, wrap_positions
from ljmd_tpu_torch.ops.pencil_sweep import sentinel_fill
from ljmd_tpu_torch.state import MDState

torch.set_num_threads(1)

L = 13.4


def _cfg(dtype):
    return SimConfig(num_cells=8, box_length=L, rc_over_box=2.5 / L, dt=0.004, dtype=dtype,
                     target_total_energy=-9000.0)


def _grid(cfg):
    return make_pencil_grid(cfg.n, cfg.box_length, cfg.rc + cfg.neighbor_skin, cfg.density)


def _carry(cfg, seed):
    """A cell-pair carry of a perturbed lattice with seeded velocities."""
    rng = np.random.default_rng(seed)
    r = fcc_lattice(8, L, dtype=torch.float64)
    r = torch.remainder(r + torch.as_tensor(rng.normal(0, 0.05, r.shape)), L)
    v = torch.as_tensor(rng.normal(0, 1.0, r.shape))
    eng = pe._cellpair_engine(cfg, "cpu", rebin_trigger="always")
    carry, _ = eng.init(MDState(r=r, ru=r, v=v, a=torch.zeros_like(r)))
    return carry


def _drifted(cfg, seed, crowd=False):
    """(r, ru, v, a, rc, vc, r_ref) of one grid: the carry's slots drifted
    (valid slots only), some across the faces and outside [0, L) by up to
    2 L, and with ``crowd`` a third of the particles moved into pencil 0
    (past its capacity)."""
    c = _carry(cfg, seed)
    gen = torch.Generator().manual_seed(seed)
    valid = c.r[3] > 0.5
    r = c.r.clone()
    step = 0.3 * torch.randn((3, r.shape[1]), generator=gen, dtype=r.dtype)
    r[0:3] = torch.where(valid[None, :], r[0:3] + step, r[0:3])
    idx = torch.nonzero(valid).flatten()
    jump = idx[torch.randperm(idx.numel(), generator=gen)[:64]]
    r[0, jump[:16]] += L
    r[1, jump[16:32]] -= 2.0 * L
    r[2, jump[32:48]] += 2.0 * L - 1e-3
    r[0, jump[48:]] = -1e-7
    if crowd:
        many = idx[torch.randperm(idx.numel(), generator=gen)[:idx.numel() // 3]]
        w = L / 4
        r[0, many] = torch.rand((many.numel(),), generator=gen, dtype=r.dtype) * w
        r[1, many] = torch.rand((many.numel(),), generator=gen, dtype=r.dtype) * w
    small = lambda: 1e-9 * torch.randn(c.r.shape, generator=gen, dtype=r.dtype)  # noqa: E731
    return r, c.ru, c.v, c.a + 0.5, small(), small(), c.r


def _stack(parts):
    return [torch.cat(ts, dim=1) for ts in zip(*parts)]


def _old_rebin(r8, others, grid, replicas):
    """The engine's rebin before ``rebin_slots`` (its closures
    ``rebin_gather_parts`` -> ``permute_rebin`` -> ``sentinel_fill`` ->
    ``counts_from_valid``) on rows already wrapped."""
    reps = 1 if replicas is None else replicas
    dtype, ns = r8.dtype, r8.shape[1]
    order, src, valid_new, overflow = rebin_gather_parts(r8, r8[3], grid, replicas=replicas)
    vmask = valid_new.to(dtype)
    parts = [r8[0:3], r8[4:5]] + [o[0:3] for o in others]
    stacked = torch.where(valid_new[None, :], torch.cat(parts, dim=0)[:, order][:, src], 0.0)
    pad3 = torch.zeros((3, ns), dtype=dtype)
    pad5 = torch.zeros((5, ns), dtype=dtype)
    r8p = torch.cat([stacked[0:3], vmask[None, :], stacked[3:4], pad3], dim=0)
    permuted = [torch.cat([stacked[4 + 3 * i:7 + 3 * i], pad5], dim=0)
                for i in range(len(others))]
    r8p = sentinel_fill(r8p, r8p[3], grid.capacity, None if replicas is None else grid.n_pencils)
    counts = r8p[3].reshape(reps * grid.n_pencils, grid.capacity).sum(dim=1).to(torch.int32)
    return r8p, permuted, counts, overflow


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.bool or not got.is_floating_point():
        assert torch.equal(got, want)
        return
    ints = torch.int64 if got.dtype == torch.float64 else torch.int32
    assert torch.equal(got.contiguous().view(ints), want.contiguous().view(ints))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("with_a", [True, False])
@pytest.mark.parametrize("replicas", [None, 3])
def test_plain_rebin_equals_the_old_composition(dtype, compensated, with_a, replicas):
    cfg = _cfg(dtype)
    grid = _grid(cfg)
    seeds = [1] if replicas is None else [1, 2, 3]
    # Replica 1 of the stack (or the one system) crowds pencil 0.
    parts = [_drifted(cfg, s, crowd=(i == len(seeds) // 2)) for i, s in enumerate(seeds)]
    r, ru, v, a, rc, vc, _ = _stack(parts)
    overflow = torch.zeros((), dtype=torch.bool) if replicas is None else \
        torch.tensor([False, False, True])
    if compensated:
        r8, rc8 = r.clone(), rc.clone()
        r8[0:3], rc8[0:3] = wrap_positions_ext(r8[0:3], rc8[0:3], L)
        others = [ru, v] + ([a] if with_a else []) + [rc8, vc]
    else:
        r8 = r.clone()
        r8[0:3] = wrap_positions(r8[0:3], L)
        others = [ru, v] + ([a] if with_a else [])
    want_r, want_o, want_counts, want_ovf = _old_rebin(r8, others, grid, replicas)
    LAUNCHES.reset()
    got_r, got_o, got_counts, got_ovf, got_max = pencil_rebin.rebin_slots(
        r8 if compensated else r, others, grid, overflow, replicas=replicas,
        wrap=not compensated)
    assert got_max is None
    assert sum(LAUNCHES.snapshot().values()) == 0
    _same_bits(got_r, want_r)
    assert len(got_o) == len(want_o) == len(others)
    for g, w in zip(got_o, want_o):
        _same_bits(g, w)
    _same_bits(got_counts, want_counts)
    _same_bits(got_ovf, overflow | want_ovf)
    # The crowded grid overflows; the others keep their flag.
    assert bool(want_ovf.flatten()[len(seeds) // 2])
    if replicas is not None:
        assert got_ovf.tolist() == [False, True, True]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("replicas", [None, 3])
def test_folded_drift_check_sets_the_invalid_check_flag(dtype, replicas):
    """``drift_ref`` folds the engine's ``_invalid_check`` into the rebin:
    minimum-image xy drift since the last rebin, times validity, its max
    against the threshold, one flag a replica. One slot of the last replica
    drifts just past the threshold; the other replicas stay under it."""
    cfg = _cfg(dtype)
    grid = _grid(cfg)
    reps = 1 if replicas is None else replicas
    carries = [_carry(cfg, 5 + q) for q in range(reps)]
    r_ref = torch.cat([c.r for c in carries], dim=1)
    r = r_ref.clone()
    r[0:2] += 0.01 * torch.where(r[3] > 0.5, 1.0, 0.0)
    thresh = (0.5 * (grid.pencil_width - cfg.rc)) ** 2
    slot = (reps - 1) * grid.n_slots + 5
    assert float(r[3, slot]) == 1.0
    r[0, slot] = r_ref[0, slot] - L + (thresh ** 0.5 + 1e-3)  # past it, across the face
    r[1, slot + 1] = r_ref[1, slot + 1] + 0.9 * thresh ** 0.5  # under it

    def invalid_check(c_r, c_ref):
        d = minimum_image(c_r[0:2] - c_ref[0:2], L)
        moved2 = torch.sum(d * d, dim=0) * c_r[3]
        if replicas is None:
            return torch.max(moved2) > thresh
        return torch.amax(moved2.reshape(reps, -1), dim=1) > thresh

    want = invalid_check(r, r_ref)
    assert want.flatten().tolist() == [False] * (reps - 1) + [True]
    overflow = torch.zeros(() if replicas is None else (reps,), dtype=torch.bool)
    _, _, _, got, _ = pencil_rebin.rebin_slots(r, [r_ref], grid, overflow, replicas=replicas,
                                               drift_ref=r_ref, drift_thresh=thresh)
    _same_bits(got, want)
    _same_bits(pencil_rebin.drift_flag(r, r_ref, L, thresh, replicas), want)
    # Without the reference the rebin leaves the flag alone.
    _, _, _, none, _ = pencil_rebin.rebin_slots(r, [r_ref], grid, overflow, replicas=replicas)
    assert not bool(none.any())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("replicas", [None, 3])
def test_folded_drift_check_keeps_the_running_max(dtype, replicas):
    """With ``drift_max`` the rebin also returns ``torch.maximum(drift_max,
    the largest squared xy drift)``, a replica's each: the engine's
    ``pencil_drift_share`` counter, with no operation of its own. A larger
    running max stays; a NaN drift makes it NaN; it needs the reference."""
    cfg = _cfg(dtype)
    grid = _grid(cfg)
    reps = 1 if replicas is None else replicas
    shape = () if replicas is None else (reps,)
    r_ref = torch.cat([_carry(cfg, 9 + q).r for q in range(reps)], dim=1)
    r = r_ref.clone()
    valid = r[3] > 0.5
    gen = torch.Generator().manual_seed(4)
    r[0:3] += 0.05 * torch.where(valid, torch.randn(r[0:3].shape, generator=gen,
                                                     dtype=r.dtype), 0.0)
    d = minimum_image(r[0:2] - r_ref[0:2], L)
    moved2 = (torch.sum(d * d, dim=0) * r[3]).reshape(reps, -1).amax(dim=1).reshape(shape)
    overflow = torch.zeros(shape, dtype=torch.bool)
    zero = torch.zeros(shape, dtype=r.dtype)
    thresh = (0.5 * (grid.pencil_width - cfg.rc)) ** 2
    out = pencil_rebin.rebin_slots(r, [r_ref], grid, overflow, replicas=replicas,
                                   drift_ref=r_ref, drift_thresh=thresh, drift_max=zero)
    assert len(out) == 5
    _same_bits(out[4], moved2)
    big = torch.full(shape, 10.0, dtype=r.dtype)
    _same_bits(pencil_rebin.rebin_slots(r, [r_ref], grid, overflow, replicas=replicas,
                                        drift_ref=r_ref, drift_thresh=thresh,
                                        drift_max=big)[4], big)
    r[1, reps * grid.n_slots - grid.capacity] = float("nan")
    last = pencil_rebin.rebin_slots(r, [r_ref], grid, overflow, replicas=replicas,
                                    drift_ref=r_ref, drift_thresh=thresh, drift_max=zero)[4]
    assert last.reshape(-1).isnan().tolist() == [False] * (reps - 1) + [True]
    with pytest.raises(ValueError, match="drift_max"):
        pencil_rebin.rebin_slots(r, [r_ref], grid, overflow, replicas=replicas, drift_max=zero)
