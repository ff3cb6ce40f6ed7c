"""Trajectory analysis (counterpart of ``ljmd_tpu/analysis``): MSD, VACF,
g(r), diffusion coefficients, ACF timescales, plots and the run-directory
report."""
