"""rmm_tpu_torch — the PyTorch + CUDA port of :mod:`rmm_tpu`.

A package of its own beside the JAX reference: it imports ``torch``,
``numpy`` and the standard library, never ``jax`` or anything of
``rmm_tpu``. Module names mirror ``rmm_tpu/`` so each counterpart is easy to
find. The TPU's Pallas kernels become CUDA kernels for Hopper (``csrc/``),
built at first use; every kernel keeps a plain PyTorch twin, which runs for
CPU tensors only.

This slice serves supervised TABGNN edge classification
(``python -m rmm_tpu_torch.cli.predict``).
"""
import torch

# The slice computes in float32 and its parity checks need full-f32
# products: TF32 would keep ~3 decimal digits in matmuls and convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
