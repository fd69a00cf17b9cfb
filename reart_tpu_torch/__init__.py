"""reart_tpu_torch: the PyTorch + CUDA port of reart_tpu for one NVIDIA H100.

The JAX package `reart_tpu` stays the reference; this package mirrors its
module paths and is tested against it on the same numpy inputs. It imports
torch and numpy only (never jax, never reart_tpu).

Every Pallas kernel on a ported path has a hand-written CUDA kernel under
`csrc/`, built on first use by `ops/_build.py`. Each kernel wrapper takes its
plain PyTorch version for a tensor on the CPU, and launches the kernel (or
raises) for a tensor on a CUDA device.
"""

import torch as _torch

# Geometry and point distances lose digits under TF32 (about three decimal
# digits): keep every float32 matmul and convolution in full float32. This
# mirrors the JAX package's "highest" default matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
