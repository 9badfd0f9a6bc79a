"""envgs_tpu_torch — the PyTorch + CUDA port of `envgs_tpu`.

Mirrors the JAX package's module paths and names (`envgs_tpu_torch/ops/
raster.py::rasterize` is the counterpart of `envgs_tpu/ops/raster.py::
rasterize`). Plain tensor code is PyTorch; each Pallas kernel of the ported
paths is a CUDA C++ kernel for Hopper (sm_90a) under `kernels/csrc/`, built
at first use on a CUDA tensor. On CPU tensors every kernel wrapper runs its
plain PyTorch version, which is what the parity tests against JAX use.

This package imports torch, numpy and scipy, never jax.
"""

__version__ = "0.1.0"

import torch as _torch

# The geometry is fp32 end to end, as `envgs_tpu` pins
# jax_default_matmul_precision="highest": the projection composes in
# prepare_splats, the ray grid in get_rays and the tracer's cone cull are
# fp32 matmuls whose culling decisions move under TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
