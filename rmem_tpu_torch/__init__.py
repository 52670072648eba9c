"""rmem_tpu_torch: the PyTorch/CUDA port of rmem_tpu for NVIDIA Hopper.

R50-DeAOTL + RMem inference and training: the restricted long-term memory
bank with importance x freshness eviction and the slot temporal PE, on
hand-written CUDA kernels for bank attention (forward and backward), local
attention and the ResNet stem. The JAX package `rmem_tpu` is the reference
it is tested against; this package imports nothing of it, nor JAX.
"""

__version__ = "0.1.0"

from rmem_tpu_torch.config import get_config  # noqa: F401
