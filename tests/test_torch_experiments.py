"""The port's kernel experiments (``ljmd_tpu_torch/experiments``) run end
to end on the CPU at a toy size, through their ``main``s, and print the
lines of their JAX counterparts (``scripts/exp_*.py``). On the CPU the
wrappers take the plain versions, so the printed times are not device
times; the card runs them at full size (``chip_smoke.py``)."""

import pytest
import torch

from ljmd_tpu_torch.experiments import layout, mosaic_support, overhead, zfloor

torch.set_num_threads(1)


def _shrink(monkeypatch, mod, **values):
    for k, v in values.items():
        monkeypatch.setattr(mod, k, v)


def test_overhead_main(monkeypatch, capsys):
    """Part A at N=864 (n_pad 896, tiles (128, 128)), part B at N=864 on a
    3x3 pencil grid at capacity 384."""
    _shrink(monkeypatch, overhead, NUM_CELLS=6, MELT_STEPS=16, N_CHUNKS=1, CHUNK_STEPS=2,
            REPS=1, TILE_J=128, PENCIL_CELLS=6, WARM_STEPS=3, PENCIL_STEPS=2)
    out = overhead.main(["--device", "cpu"])
    text = capsys.readouterr().out
    for line in ("N=864 n_pad=896 tiles=49 active=", "zsort fused chunk us/step:  zero=",
                 "pair-math rate (ones-zero):", "warmup done", "grid m=3 cap=384 pencils=9",
                 "engine step_fast:", "hs sweep alone:", "candidates/step ="):
        assert line in text, line
    assert out["a"]["active"] > 0 and out["b"]["candidates"] > 0


def test_zfloor_main(monkeypatch, capsys):
    _shrink(monkeypatch, zfloor, NUM_CELLS=6, MELT_STEPS=16, N_CHUNKS=1, CHUNK_STEPS=2,
            REPS=1, TILES=((128, 128), (128, 512), (128, 896)))
    out = zfloor.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "melt done" in text
    assert "TI=128 TJ=  128 visits=  49: zero=" in text
    assert "TI=128 TJ=  896 visits=   7: zero=" in text
    assert "TJ=  512" not in text  # 512 does not divide n_pad 896
    assert [r["tile_j"] for r in out] == [128, 896]


def test_mosaic_support_main(monkeypatch, capsys):
    _shrink(monkeypatch, mosaic_support, ITERS=3, REPS=1)
    out = mosaic_support.main(["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ": OK " in ln]
    assert len(lines) == 9 and all("(3 iters) sum=" in ln for ln in lines)
    assert out["rowsum"]["sum"] == pytest.approx(128 * 512 * (1 + 2 + 3))


def test_layout_main(monkeypatch, capsys):
    _shrink(monkeypatch, layout, N_PAD=1024, STEPS=1, OUTER=1, REPS=1, V_LO=2, V_HI=4,
            ITERS_LO=1, ITERS_HI=2)
    out = layout.main(["--device", "cpu", "k1-512", "k2-128", "k5c-512", "k6-512", "trans",
                       "dot"])
    text = capsys.readouterr().out
    for label in ("K1  current body   (512 lanes j)", "K2  transposed tile (128 sub j)",
                  "K5c K5b+masked loop body (512)", "K6  pure-math ceiling    (512)",
                  "jnp.transpose (8, 1024)", "jnp.transpose (1024, 8)",
                  "dot-transpose (N,8)->(8,N) chunked"):
        assert label in text, label
    assert len(out) == 7 and text.count("ns/unit") == 7


def test_experiments_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        mosaic_support.main([])
