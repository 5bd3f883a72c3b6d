"""PyTorch/CUDA port of the GPipe pipeline runtime (``repro``'s counterpart).

Same subpackage layout as :mod:`repro`, so every module here has its JAX
reference at the same relative path.  The port imports ``torch`` and
``numpy`` only: never ``jax`` and nothing of :mod:`repro`.  Hopper kernels
live under :mod:`repro_torch.kernels` and are built on first use, never at
import time.
"""
