"""The port's ``ensemble`` command on the CPU: in memory, with
``--per-run-dirs`` and with ``--stream``; its artifact files against what
the JAX package's ``write_ensemble_artifacts`` writes from the same numbers.
"""

import json
import os
import re
import types

import numpy as np
import pytest
import torch

from ljmd_tpu.cli import write_ensemble_artifacts as j_write
from ljmd_tpu_torch import cli
from ljmd_tpu_torch.config import load_config
from ljmd_tpu_torch.parallel import ensemble as pens

torch.set_num_threads(1)

CFG = {"num_cells": 2, "box_length": 3.6, "rc_over_box": 0.45, "total_steps": 300,
       "output_interval": 10, "warmup_steps": 50, "dt": 0.003, "dtype": "float64",
       "target_total_energy": -60.0, "seed": 5, "n_runs": 3}
FILES = ["means.txt", "simulation_results.txt", "simulation_results.json"] + [
    f"corrmean_runs_{o}.dat" for o in ("epot", "ekin", "etot", "temp", "press")]
NUMBER = re.compile(r"[-+]?\d+\.\d+e[-+]\d+|[-+]?(?:nan|inf)")


def _config(tmp_path, **kw) -> str:
    path = tmp_path / "ens.json"
    path.write_text(json.dumps({**CFG, **kw}))
    return str(path)


def _run(capsys, *argv) -> dict:
    assert cli.main(["ensemble", *argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if x.startswith('{"ensemble"'))
    return json.loads(line)["ensemble"]


def _numbers(path) -> list:
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return [float(x) for x in re.findall(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?|NaN|-?Infinity",
                                              text)]
    return [float(x) for x in NUMBER.findall(text)]


def _same_files(got_dir, want_dir):
    """Every artifact of both directories: the same text outside the
    numbers, and the numbers within 1e-12 (relative)."""
    for name in FILES:
        g, w = os.path.join(got_dir, name), os.path.join(want_dir, name)
        with open(g) as fg, open(w) as fw:
            tg, tw = fg.read(), fw.read()
        strip = NUMBER if not name.endswith(".json") else re.compile(r"[-+]?[\d.e+-]+")
        assert strip.sub("#", tg) == strip.sub("#", tw), name
        np.testing.assert_allclose(_numbers(g), _numbers(w), rtol=1e-12, atol=0, err_msg=name)


def _jax_view(out):
    """The port's EnsembleResult as the numpy object JAX's writer reads."""
    host = {k: np.asarray(getattr(out, k).cpu()) for k in (
        "replica_means", "mean_of_means", "std_of_means", "corr_mean_runs",
        "corr_norm_mean_runs")}
    thermo = {k: np.asarray(v.cpu()) for k, v in out.thermo.as_dict().items()}
    return types.SimpleNamespace(**host, thermo=types.SimpleNamespace(as_dict=lambda: thermo))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ensemble_artifacts_match_jax_writer(tmp_path, dtype):
    """The same numbers through both packages' writers give the same files."""
    cfg = load_config(_config(tmp_path, dtype=dtype))
    out = pens.ensemble_simulate(cfg, backend="rows", device="cpu")
    cli.write_ensemble_artifacts(str(tmp_path / "port"), cfg, out, 3)
    j_write(str(tmp_path / "jax"), cfg, _jax_view(out), 3)
    _same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_ensemble_cli_in_memory_and_per_run_dirs(tmp_path, capsys):
    path = _config(tmp_path)
    summary = _run(capsys, "--config", path, "--out-dir", str(tmp_path / "a"), "--per-run-dirs")
    assert summary["replicas"] == 3 and summary["n_ok"] == 3 and summary["batched"]
    assert summary["engine"] == "rows" and summary["n"] == 32
    assert summary["particle_steps_per_s"] > 0
    runs = (tmp_path / "a" / "several_runs.txt").read_text().split()
    assert runs == [str(tmp_path / "a" / f"run_{i:04d}") for i in range(3)]
    for d in runs:
        for name in ("instantaneous_energies.dat", "means.dat", "summary.json",
                     "md_final_results.txt", "corr_etot.dat", "corrmean_etot.dat"):
            assert os.path.getsize(os.path.join(d, name)) > 0
        assert not os.path.exists(os.path.join(d, "rva.dat"))
    # the numbers of the command are ensemble_simulate's: the JAX writer's files
    cfg = load_config(path)
    out = pens.ensemble_simulate(cfg, backend="rows", device="cpu")
    j_write(str(tmp_path / "jax"), cfg, _jax_view(out), 3)
    _same_files(str(tmp_path / "a"), str(tmp_path / "jax"))
    # replica 1's run directory holds replica 1's means
    got = json.loads((tmp_path / "a" / "run_0001" / "summary.json").read_text())
    assert got["means"]["epot"]["mean"] == pytest.approx(float(out.replica_means[1, 0]),
                                                         rel=1e-12)


def test_ensemble_cli_stream_equals_in_memory(tmp_path, capsys):
    path = _config(tmp_path)
    _run(capsys, "--config", path, "--out-dir", str(tmp_path / "mem"), "--n-runs", "2")
    summary = _run(capsys, "--config", path, "--out-dir", str(tmp_path / "st"), "--n-runs", "2",
                   "--stream", "--chunk-samples", "5")
    assert summary["replicas"] == 2 and summary["stream"]["chunks"] == 5
    for name in FILES:
        assert (tmp_path / "st" / name).read_text() == (tmp_path / "mem" / name).read_text(), name
    with pytest.raises(SystemExit):
        cli.main(["ensemble", "--config", path, "--device", "cpu", "--stream",
                  "--per-run-dirs", "--out-dir", str(tmp_path / "x")])
