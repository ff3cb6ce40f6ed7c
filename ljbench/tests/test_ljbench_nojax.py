import subprocess
import sys
from pathlib import Path

from ljbench.run import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_by_whole_top_level_name():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "ljmd_tpu", "ljmd_tpu.ops.lj",
             "ljmd_tpu_torch", "ljmd_tpu_torch.ops._cuda", "jaxtyping", "torch", "ljbench.run"]
    assert forbidden_modules(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                                        "ljmd_tpu", "ljmd_tpu.ops.lj"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "ljmd_tpu"}


def test_harness_loads_no_jax():
    code = ("import sys, ljbench.run, ljbench.harness, ljbench.calibrate, ljbench.trace; "
            "from ljbench.run import forbidden_modules; "
            "from ljbench.spec import reader, load_cell; "
            "[reader(m) for m in ('particle_steps_per_s', 'pair_roofline_pct')]; "
            "load_cell('n62500.single.i2', 1); "
            "print(forbidden_modules(list(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
