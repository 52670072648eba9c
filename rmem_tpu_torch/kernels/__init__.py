"""Hand-written CUDA kernels for Hopper (sources in ../csrc), one module
each, and their build. A wrapper launches its kernel for tensors on the card
and runs its plain PyTorch version for tensors on the CPU; it counts its
launches on itself (`.launches`, through launches.py)."""

from __future__ import annotations
