"""The benchmark's plain reference, written from the methods' definitions
(2DGS and EnvGS's base pass, 3DGS's EWA projection, real SH of degree 3,
the recipes' losses and sparse Adam) in plain PyTorch: its own binning of
every (tile, splat) of each splat's box, its own projection and colours.
Only the per-tile blend and its backward are frozen copies of the
repository's plain versions of kernels K1 and K2 (`raster_blend.py`),
which the repository's CPU tests hold to the JAX package.

It imports nothing of `envgs_tpu_torch`, `envgs_tpu` or JAX and takes
nothing the program made: the harness hands it the raw tensors it made
from the run's seed. The plain blend records the (pair, pixel)
evaluations that contribute in `raster_blend.WALKS`, the count the
rooflines and utilizations are taken against.
"""
