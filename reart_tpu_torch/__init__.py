"""reart_tpu_torch: the PyTorch + CUDA port of reart_tpu for one NVIDIA H100.

The JAX package `reart_tpu` stays the reference; this package mirrors its
module paths and is tested against it on the same numpy inputs. It imports
torch and numpy only (never jax, never reart_tpu).

Entry points (`BaseModel`, `train.fit_base`, `cli.main`, `cli.finalize`)
run on the card unless the caller asks for another device.

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


def resolve_device(device=None) -> "_torch.device":
    """The device an entry point runs on: the card unless the caller names
    another (`device="cpu"`, `--device cpu`). There is no fallback: without
    a CUDA device the default raises."""
    dev = _torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "reart_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "(--device cpu) to run the plain PyTorch versions on the CPU")
    return dev


def device_of(*values, device=None) -> "_torch.device":
    """The device a library function works on: that of the first tensor
    among `values`; for arrays only, `device` as `resolve_device` reads it
    (the card when None)."""
    for v in values:
        if isinstance(v, _torch.Tensor):
            return v.device
    return resolve_device(device)


def to_numpy(value):
    """A numpy array of a tensor (detached, from any device) or of
    anything np.asarray accepts."""
    import numpy as np

    if isinstance(value, _torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def tree_to_numpy(value):
    """`value` with every tensor turned into a numpy array, through dicts,
    lists and tuples (what a pickle that names no device holds)."""
    if isinstance(value, _torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: tree_to_numpy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(tree_to_numpy(v) for v in value)
    return value
