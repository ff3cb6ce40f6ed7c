"""The port's CLI pipeline on the CPU, through subprocesses:
``simulate --stream`` (its artifacts byte for byte those of the in-memory
``simulate``) then ``analyze``, ``run-all``, and ``analyze --device cuda``
refused where there is no card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLI_CFG = {
    "num_cells": 2, "box_length": 3.8, "rc_over_box": 0.45, "total_steps": 230,
    "output_interval": 10, "warmup_steps": 25, "dt": 0.002, "dtype": "float64",
    "target_total_energy": -60.0,
}
ARTIFACTS = ("rva.dat", "instantaneous_energies.dat", "means.dat", "md_final_results.txt",
             "summary.json") + tuple(f"{p}_{o}.dat" for p in ("corr", "corrmean")
                                     for o in ("epot", "ekin", "etot", "temp", "press"))


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "ljmd_tpu_torch", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _json_line(stdout: str, key: str) -> dict:
    return next(json.loads(line)[key] for line in stdout.splitlines()
                if line.startswith(f'{{"{key}"'))


@pytest.fixture(scope="module")
def cfg_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    p = d / "cfg.json"
    p.write_text(json.dumps(CLI_CFG))
    return p


def test_simulate_stream_then_analyze(cfg_file):
    d = cfg_file.parent
    init = d / "rv_init.dat"
    proc = _run(["init-config", "--config", str(cfg_file), "--out", str(init), "--device",
                 "cpu"], str(d))
    assert proc.returncode == 0, proc.stderr
    base = ["--config", str(cfg_file), "--from-init", str(init), "--device", "cpu"]
    mem = _run(["simulate", "--out-dir", str(d / "mem"), *base], str(d))
    assert mem.returncode == 0, mem.stderr
    st = _run(["simulate", "--out-dir", str(d / "stream"), "--stream", "--chunk-samples", "4",
               *base], str(d))
    assert st.returncode == 0, st.stderr
    stream = _json_line(st.stdout, "stream")
    assert stream["writer"] == "native" and stream["chunks"] == 6
    assert stream["frames_written"] == 21 and stream["resumed_from"] is None
    assert not any(_json_line(st.stdout, "diagnostics").values())
    for f in ARTIFACTS:
        assert (d / "stream" / f).read_bytes() == (d / "mem" / f).read_bytes(), f
    assert not (d / "stream" / "production_checkpoint.npz").exists()

    an = _run(["analyze", "--run-dir", str(d / "stream"), "--device", "cpu", "--no-plots",
               "--rva-max-lag", "9"], str(d))
    assert an.returncode == 0, an.stderr
    assert "D_einstein=" in an.stdout
    summary = json.loads((d / "stream" / "analysis_summary.json").read_text())
    traj = summary["trajectory"]
    assert traj["n_snapshots"] == 21 and traj["max_lag"] == 9
    assert np.isfinite([traj["D_einstein"], traj["D_green_kubo"]]).all()
    assert "plots" not in summary and set(summary["acf"]) == {"epot", "ekin", "etot", "temp",
                                                             "press"}


def test_run_all(cfg_file, tmp_path):
    proc = _run(["run-all", "--config", str(cfg_file), "--out-dir", str(tmp_path / "run"),
                 "--device", "cpu", "--stream"], str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    summary = json.loads((tmp_path / "run" / "analysis_summary.json").read_text())
    assert summary["n_samples"] == 21 and summary["trajectory"]["n_snapshots"] == 21
    assert len(summary["plots"]) == 20
    assert all(os.path.isfile(p) for p in summary["plots"])
    for f in ARTIFACTS:
        assert (tmp_path / "run" / f).is_file(), f


def test_analyze_device_cuda_without_a_card(cfg_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(["analyze", "--run-dir", str(tmp_path), "--device", "cuda", "--no-plots"],
                str(tmp_path))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not (tmp_path / "analysis_summary.json").exists()
