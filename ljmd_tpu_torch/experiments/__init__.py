"""Kernel experiments of the port, one module per experiment script of the
JAX package (``scripts/exp_*.py``), each run with

    python -m ljmd_tpu_torch.experiments.<name>

on the card (``--device cpu`` runs the plain versions at a toy size):

- ``overhead``: the flag-gated dense chunk with zero / real / all flags at
  N=4000, and the half-shell pencil sweep alone against the cell-pair step
  at config 5's grid;
- ``zfloor``: the flag-gated chunk's zero-flag floor across tile widths;
- ``mosaic_support``: the nine layout probes (kernel 17);
- ``layout``: the per-visit cost of the pair-tile layout bodies (kernel 18).

Times are CUDA-event times on the card; on the CPU they time the plain
versions and are no device numbers.
"""
