"""Kernel 18's plain versions (``ljmd_tpu_torch/experiments/layout.py``
``layout_body_plain``) against the Pallas bodies of ``scripts/exp_layout.py``
in interpret mode, float32 on the CPU.

The script is imported by path with ``N_PAD = 1024``, ``STEPS = 2``,
``OUTER = 1`` and the box shrunk to ``L = 5`` (lattice spacing 0.45, so the
forces, which reach r only through f * 1e-9, move row 1 by ~1e-3 and the
comparison sees them); both sides get the port's lattice state and visit
lists (8 visits whose columns never meet their rows). rtol 1e-5: the TPU
bodies take a fast reciprocal and a Newton step where the port divides, and
sum the tile in another order.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from ljmd_tpu_torch.experiments import layout as ly

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts", "exp_layout.py")
N_PAD, STEPS, V, BOX = 1024, 2, 8, 5.0

# (port body, width, the script's runner and its extra arguments)
CASES = {
    "k1-512": ("run_k1", {}), "k1-128": ("run_k1", {}), "k2b-512": ("run_k2b", {}),
    "k2-512": ("run_k2", {}), "k2-128": ("run_k2", {}), "k3-512": ("run_k3", {}),
    "k4-512": ("run_k4", {}), "k4z-512": ("run_k4", {"mic_z": False}),
    "k5a-512": ("run_k5", {"tail": False, "second_loop": False}),
    "k5b-512": ("run_k5", {"tail": True, "second_loop": False}),
    "k5c-512": ("run_k5", {"tail": True, "second_loop": True}),
    "k6-512": ("run_k6", {}),
}


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("exp_layout_under_test", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", list(CASES))
def test_layout_body_plain_matches_pallas(script, monkeypatch, case):
    for k, val in (("N_PAD", N_PAD), ("STEPS", STEPS), ("OUTER", 1), ("L", BOX)):
        monkeypatch.setattr(script, k, val)
    monkeypatch.setattr(ly, "L", BOX)
    name, w = case.rsplit("-", 1)
    tj_w = int(w)
    runner, extra = CASES[case]
    r8, rT = ly.make_state(0, N_PAD)
    ti, tj = ly.variant_lists(name, tj_w, *ly.visit_lists(V, 7, N_PAD), N_PAD)
    got = ly.layout_body_plain(name, r8, rT, ti, tj, V, tj_w, STEPS, box=BOX)
    jr8, jrT = jnp.asarray(r8.numpy()), jnp.asarray(rT.numpy())
    jti, jtj = (jnp.asarray(np.asarray(x, dtype=np.int32)) for x in (ti, tj))
    lead = (jr8, jrT) if runner in ("run_k2b", "run_k2", "run_k3") else (jr8,)
    with pltpu.force_tpu_interpret_mode(pltpu.InterpretParams(uninitialized_memory="zero")):
        g, args = getattr(script, runner)(*lead, jti, jtj, V, tj_w, **extra)
        want = np.asarray(jax.block_until_ready(g(*args)))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # The forces moved row 1 well past float32's resolution.
    assert np.abs(want[1] - r8[1].numpy()).max() > 1e-4


def test_visit_lists_never_meet_their_rows():
    ti, tj = ly.visit_lists(64, 3, 4096)
    assert len(ti) == 64 and not any(ly._overlaps(a, b, 4096) for a, b in zip(ti, tj))
    r8, rT = ly.make_state(1, 4096)
    assert r8.shape == (8, 4096) and np.array_equal(rT[:, 0:3].numpy(), r8[0:3].T.numpy())
    assert float(r8[0:3].min()) >= 0.0 and float(r8[0:3].max()) < ly.L
