"""Kernel 8's plain version (``ljmd_tpu_torch/ops/fused.py``
``fused_dense_chunk_flags_plain``) against the JAX package's
``fused_dense_chunk_flags`` in interpret mode, float64 on the CPU.

N=864 (a z-sorted, perturbed FCC lattice in the config-from-density box at
rho 0.8442) padded to 1024, tiles (128, 512): 16 flags. Plain and extended
(r_lo / vc) chunks of 3 steps with the fluid's real flags, all-zero, all-3
and a random 0/1 pattern (the pattern that catches a pair whose two sides
read different flags). Tolerances are tests/test_fused.py's for the fused
chunks: rtol 1e-10, atol 1e-12 (the JAX kernel is pair-once, the port's
pair-twice: summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.ops.pallas_fused import fused_dense_chunk_flags as j_flags_chunk
from ljmd_tpu_torch.models.lattice import fcc_lattice
from ljmd_tpu_torch.ops import fused
from ljmd_tpu_torch.ops.pair_sweep import pair_forces_plain
from ljmd_tpu_torch.ops.window_lists import compute_tile_flags

torch.set_num_threads(1)

N, N_PAD, TILE_J = 864, 1024, 512
BOX = (N / 0.8442) ** (1.0 / 3.0)
RC2, DT, STEPS = 6.25, 0.004, 3


@pytest.fixture(scope="module")
def fluid():
    rng = np.random.default_rng(8)
    r = fcc_lattice(6, BOX, dtype=torch.float64).numpy()
    r = np.mod(r + rng.normal(scale=0.06, size=r.shape), BOX)
    r = r[np.argsort(r[:, 2])]
    rows = torch.zeros((8, N_PAD), dtype=torch.float64)
    rows[0:3, :N] = torch.as_tensor(r.T)
    v = torch.zeros_like(rows)
    v[0:3, :N] = torch.as_tensor(rng.uniform(-1.0, 1.0, (3, N)))
    a = 24.0 * pair_forces_plain(rows, N, BOX, RC2)
    lo = torch.zeros_like(rows)
    lo[0:3, :N] = torch.as_tensor(rng.uniform(-1e-9, 1e-9, (3, N)))
    vc = torch.zeros_like(rows)
    vc[0:3, :N] = torch.as_tensor(rng.uniform(-1e-9, 1e-9, (3, N)))
    real = compute_tile_flags(rows, N, 128, TILE_J, BOX, 2.5 + 0.7)
    n_flags = (N_PAD // 128) * (N_PAD // TILE_J)
    flags = {"real": real, "zero": torch.zeros(n_flags, dtype=torch.int32),
             "all3": torch.full((n_flags,), 3, dtype=torch.int32),
             "random": torch.as_tensor(np.random.default_rng(5).integers(0, 2, n_flags)
                                       .astype(np.int32))}
    return rows, v, a, lo, vc, flags


@pytest.mark.parametrize("pattern", ["real", "zero", "all3", "random"])
@pytest.mark.parametrize("extended", [False, True])
def test_flags_chunk_plain_matches_jax(fluid, pattern, extended):
    r, v, a, lo, vc, flags = fluid
    f = flags[pattern]
    kw = dict(r_lo=lo, vc=vc) if extended else {}
    got = fused.fused_dense_chunk_flags_plain(r, v, a, f, N, BOX, RC2, DT, STEPS,
                                              tile_j=TILE_J, **kw)
    jkw = {k: jnp.asarray(t.numpy()) for k, t in kw.items()}
    want = j_flags_chunk(*(jnp.asarray(t.numpy()) for t in (r, v, a)), jnp.asarray(f.numpy()),
                         N, BOX, RC2, DT, STEPS, tile_j=TILE_J, interpret=True, **jkw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)
    # The wrapper takes the plain version on CPU tensors.
    for g, w in zip(fused.fused_dense_chunk_flags(r, v, a, f, N, BOX, RC2, DT, STEPS,
                                                  tile_j=TILE_J, **kw), got):
        assert torch.equal(g, w)


def test_flags_gate_and_checks(fluid):
    """The gate is symmetric and follows the upper-triangle tile of each
    pair; all-3 flags give the dense chunk; a wrong tiling raises."""
    r, v, a, _, _, flags = fluid
    gate = fused.tile_gate(flags["random"], N, N_PAD, 128, TILE_J)
    assert torch.equal(gate, gate.T)
    f2 = flags["random"].reshape(N_PAD // 128, N_PAD // TILE_J)
    i, j = 5, 700
    assert bool(gate[i, j]) == bool(f2[i // 128, j // TILE_J] > 0)
    dense = fused.fused_dense_chunk_plain(r, v, a, N, BOX, RC2, DT, 2)
    for g, w in zip(fused.fused_dense_chunk_flags_plain(r, v, a, flags["all3"], N, BOX, RC2,
                                                        DT, 2, tile_j=TILE_J), dense):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="one per"):
        fused.fused_dense_chunk_flags_plain(r, v, a, flags["zero"][:5], N, BOX, RC2, DT, 1)
    with pytest.raises(ValueError, match="multiples of 128"):
        fused.fused_dense_chunk_flags_plain(r, v, a, flags["zero"], N, BOX, RC2, DT, 1,
                                            tile_j=384)
