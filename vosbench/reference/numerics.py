"""The arithmetic of the plain reference: float32 with TF32 off, or, for
the control, every matmul and conv operand rounded to float8 (e4m3, one
scale per tensor) before an f32 product.

The configurations state bfloat16 compute; the control is the reference
computed in the precision just below it, which is what a later change that
swapped bf16 for fp8 would produce.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def tf32_off() -> None:
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with the scale amax / 448, back in f32."""
    x = x.float()
    amax = x.abs().amax().clamp(min=1e-30)
    s = amax / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Numerics:
    """The operand rounding of one reference model: `precision` is
    "float32" (the reference) or "fp8" (the control)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision
        # a FLOP count on the meta device (counts/model_flops.py): the
        # products that a counter cannot see go to extra_flops, forward
        # only or, with training_count, forward and backward
        self.counting = False
        self.training_count = False
        self.extra_flops = 0.0
        self.cache = {}

    def on_device(self, key, device, make):
        """A constant tensor made once (by `make`, on the host) and kept on
        `device` for this model's later calls."""
        k = (key, str(device))
        if k not in self.cache:
            self.cache[k] = make().to(device)
        return self.cache[k]

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A matmul or conv operand as this precision rounds it (f32)."""
        if self.precision == "fp8":
            return fp8_round(x)
        return x.float()
