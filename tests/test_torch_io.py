"""PyTorch port config, IO, CLI and import hygiene, against the JAX package
where both have the function (config parsing, artifact writers, rv_init)."""

import dataclasses
import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ljmd_tpu import config as jconfig
from ljmd_tpu.config import config_from_density
from ljmd_tpu.io import artifacts as jart
from ljmd_tpu.io import checkpoint as jckpt
from ljmd_tpu.models import simulation as jsim
from ljmd_tpu_torch import config as pconfig
from ljmd_tpu_torch.cli import main as pmain
from ljmd_tpu_torch.io import artifacts as part
from ljmd_tpu_torch.io import checkpoint as pckpt
from ljmd_tpu_torch.models import simulation as psim
from ljmd_tpu_torch.stats.moments import MeansReport
from ljmd_tpu_torch.utils import convert

# Small tensors: one intra-op thread per test worker (the suite runs in
# several worker processes at once).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ljmd_tpu_torch")

REFERENCE_TEXT = """# Simulation parameters
k total_steps output_interval warmup_steps
3 2000 20 100
dt L rc_over_L
1.0D-3 5.2d0 0.45
target_total_energy
-430.d00
"""

CLI_CFG = {
    "num_cells": 2, "box_length": 3.8, "rc_over_box": 0.45, "total_steps": 120,
    "output_interval": 10, "warmup_steps": 25, "dt": 0.002, "dtype": "float64",
    "target_total_energy": -60.0,
}


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "examples", "*.json"))))
def test_config_json_parses_like_jax(path):
    assert _fields(pconfig.load_config(path)) == _fields(jconfig.load_config(path))


def test_config_reference_text_and_density_parse_like_jax(tmp_path):
    p = tmp_path / "input_simulation_parameters.txt"
    p.write_text(REFERENCE_TEXT)
    assert _fields(pconfig.load_config(str(p))) == _fields(jconfig.load_config(str(p)))
    q = tmp_path / "density.json"
    q.write_text(json.dumps({"num_cells": 3, "density": 0.8442, "rc": 2.2, "dt": 0.004}))
    assert _fields(pconfig.load_config(str(q))) == _fields(jconfig.load_config(str(q)))
    with pytest.raises(ValueError):
        pconfig.parse_reference_input("3 2000 20 100\n")


def _torch_result(jres) -> psim.SimResult:
    """The port's SimResult holding exactly the numbers of a JAX SimResult."""
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    return psim.SimResult(
        final_state=convert.state_from_numpy(
            {k: np.asarray(getattr(jres.final_state, k)) for k in convert.STATE_FIELDS}),
        times=t(jres.times), series=t(jres.series),
        means=MeansReport(count=t(jres.means.count), means=t(jres.means.means),
                          stds=t(jres.means.stds)),
        corr=t(jres.corr), corr_norm=t(jres.corr_norm), corr_mean=t(jres.corr_mean),
        corr_mean_norm=t(jres.corr_mean_norm),
        frames=psim.Frames(*(t(getattr(jres.frames, k)) for k in convert.STATE_FIELDS)),
        diagnostics={},
    )


def test_artifact_writers_are_byte_identical(tmp_path):
    """Same numbers in, same bytes out: every artifact file (text, JSON and
    the rva.dat frames) of the two writers."""
    jcfg = config_from_density(num_cells=2, density=0.7, dt=0.002, dtype="float64",
                               total_steps=60, output_interval=10, warmup_steps=10,
                               target_total_energy=-60.0)
    jres = jsim.run_production(jcfg, jsim.initialize(jcfg, backend="dense"),
                               backend="dense", record_frames=True)
    pcfg = pconfig.SimConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(jcfg) if f.init})
    jpaths = jart.write_run_artifacts(str(tmp_path / "jax"), jcfg, jres)
    ppaths = part.write_run_artifacts(str(tmp_path / "torch"), pcfg, _torch_result(jres))
    assert sorted(jpaths) == sorted(ppaths) and "rva" in ppaths
    for key, jp in jpaths.items():
        with open(jp, "rb") as f1, open(ppaths[key], "rb") as f2:
            assert f1.read() == f2.read(), key
    parsed = part.parse_final_results(ppaths["final_results"])
    assert parsed["num_particles"] == pcfg.n


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_rv_init_crosses_packages(tmp_path, writer):
    rng = np.random.default_rng(9)
    r, v = rng.uniform(0, 4.0, (32, 3)), rng.normal(size=(32, 3))
    path = str(tmp_path / "rv_init.dat")
    if writer == "jax":
        import jax.numpy as jnp

        from ljmd_tpu.state import MDState as JState

        jr = jnp.asarray(r)
        jckpt.save_rv_init(path, JState(r=jr, ru=jr, v=jnp.asarray(v), a=jnp.zeros_like(jr)))
        got = convert.state_to_numpy(pckpt.load_rv_init(path, 32, dtype=torch.float64))
        np.testing.assert_array_equal(got["r"], r)
        np.testing.assert_array_equal(got["ru"], r)
        np.testing.assert_array_equal(got["v"], v)
        np.testing.assert_array_equal(got["a"], 0.0)
    else:
        pckpt.save_rv_init(path, convert.state_from_numpy(
            {"r": r, "ru": r, "v": v, "a": np.zeros_like(r)}))
        got = jckpt.load_rv_init(path, 32, dtype=np.float64)
        np.testing.assert_array_equal(np.asarray(got.r), r)
        np.testing.assert_array_equal(np.asarray(got.v), v)


def _run_cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "ljmd_tpu_torch", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_init_and_simulate_on_cpu_subprocess(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(CLI_CFG))
    init = tmp_path / "rv_init.dat"
    proc = _run_cli(["init-config", "--config", str(cfg), "--out", str(init),
                     "--device", "cpu"], cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert init.exists()
    run_dir = tmp_path / "run"
    proc = _run_cli(["simulate", "--config", str(cfg), "--out-dir", str(run_dir),
                     "--from-init", str(init), "--device", "cpu"], cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    for f in ("instantaneous_energies.dat", "corr_epot.dat", "corrmean_press.dat",
              "md_final_results.txt", "means.dat", "summary.json", "rva.dat"):
        assert (run_dir / f).exists(), f
    series = np.loadtxt(run_dir / "instantaneous_energies.dat")
    assert series.shape == (10, 6) and np.isfinite(series).all()
    # the CPU path takes the plain twins: no kernel is launched
    launches = [json.loads(line) for line in proc.stdout.splitlines()
                if line.startswith('{"kernel_launches"')]
    assert launches and not any(launches[0]["kernel_launches"].values())


def test_cli_device_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(CLI_CFG))
    with pytest.raises(SystemExit, match="no CUDA device"):
        pmain(["simulate", "--config", str(cfg), "--out-dir", str(tmp_path / "run"),
               "--device", "cuda"])


def test_cli_rejects_unusable_target_energy(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dict(CLI_CFG, target_total_energy=-1e6, warmup_steps=0)))
    with pytest.raises(SystemExit, match="target_total_energy"):
        pmain(["init-config", "--config", str(cfg), "--out", str(tmp_path / "rv.dat"),
               "--device", "cpu"])


def test_importing_the_port_leaves_jax_out():
    """Every module of ljmd_tpu_torch imports without jax (subprocess: this
    test process has jax loaded already)."""
    code = (
        "import pkgutil, importlib, sys, ljmd_tpu_torch\n"
        "for m in pkgutil.walk_packages(ljmd_tpu_torch.__path__, 'ljmd_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k in ('jax', 'ljmd_tpu') or k.startswith(('jax.', 'jaxlib', 'ljmd_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_port_sources_stay_torch_native():
    """No jax, no torch.compile, no import of the JAX package in the port;
    every CUDA source names the TPU kernel it replaces."""
    for path in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        src = open(path).read()
        assert not re.search(r"^\s*(import jax|from jax)", src, re.M), path
        assert not re.search(r"^\s*(import ljmd_tpu\b|from ljmd_tpu[. ])", src, re.M), path
        assert "torch.compile" not in src, path
    for name in ("lj_pair_terms.cuh", "pair_sweep_tri.cu", "fused_dense_chunk.cu",
                 "pair_sweep.cu", "pencil_sweep_full.cu", "pencil_sweep_zband.cu",
                 "pencil_rebin.cu", "zsort_resort.cu", "fused_dense_chunk_list.cu"):
        head = open(os.path.join(PKG, "csrc", name)).read()[:1500]
        assert "Replaces: ljmd_tpu/ops/" in head, name
        assert "What bounds it" in head and "What the design does" in head, name
