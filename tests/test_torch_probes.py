"""Kernel 17's plain versions (``ljmd_tpu_torch/experiments/mosaic_support.py``)
against the nine Pallas probes of ``scripts/exp_mosaic_support.py``, float32
on the CPU.

The script is imported by path with ``ITERS`` set to 3. Six probes add into
outputs they never initialise, so the Pallas probes run in interpret mode
with zero-initialised memory (the port zero-fills those outputs). Both sides
get the same inputs (checked equal), rtol 1e-6 (the row sums add in another
order; everything else is the same float32 operations).
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ljmd_tpu_torch.experiments import mosaic_support as ms

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts", "exp_mosaic_support.py")
ITERS = 3


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("exp_mosaic_support_under_test", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", [n for n, _ in ms.PROBES])
def test_probe_plain_matches_pallas(script, monkeypatch, name):
    monkeypatch.setattr(script, "ITERS", ITERS)
    with pltpu.force_tpu_interpret_mode(pltpu.InterpretParams(uninitialized_memory="zero")):
        f, args = getattr(script, f"build_{name}")()
        want = np.asarray(jax.block_until_ready(f(*args)))
    inputs = ms.probe_inputs(name, "cpu", n=script.N, iters=ITERS)
    assert len(inputs) == len(args)
    for got_in, want_in in zip(inputs, args):
        np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    got = ms.probe(name, *inputs, iters=ITERS, n=script.N)  # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
