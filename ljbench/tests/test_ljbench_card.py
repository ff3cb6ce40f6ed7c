"""A short run of a cell on the card through the command the benchmark
runs; skips where there is no card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, "-m", "ljbench.run", "--workload", "n62500.single.i100",
                          "--seed", "3000000001", "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["attempted"] > 0
    assert list(line)[-1] == "checks"
