"""The ConvGRU cells of RMem's compressed memory (`gru_memory`).

Counterpart of `rmem_tpu/models/conv_gru.py`: when the bank evicts a slot,
its keys and values go through a ConvGRU a plane whose hidden state lives
across evictions, and the cell's output replaces slot 1, the compressed
memory. Module names follow the flax tree (`cell.conv_gates`,
`cell.conv_can`, `output_conv`), so utils/checkpoint.params_from_jax maps
one onto the other. Tensors are channel-last [B, H, W, C], as the JAX
package's hidden states are; the convs are cuDNN's (XLA convs there).

The K plane's cell has a 2 x 2 kernel. Its "same" padding puts the extra
row and column at the bottom and right, as torch's padding='same' does for
an even kernel, so the cell pads explicitly and convolves unpadded.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> an NCHW view, channels-last in memory."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ConvGRUCell(nn.Module):
    """Reset and update gates from one conv of [x, h], the candidate from
    one conv of [x, reset * h]; h' = (1 - update) * h + update * cand."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel: int = 2):
        super().__init__()
        self.kernel = kernel
        self.conv_gates = nn.Conv2d(input_dim + hidden_dim, 2 * hidden_dim,
                                    kernel)
        self.conv_can = nn.Conv2d(input_dim + hidden_dim, hidden_dim, kernel)

    def _same(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW zero padding for a stride-1 'same' conv: k // 2 after,
        k // 2 - 1 before for an even kernel (k // 2 each side for odd)."""
        k = self.kernel
        after, before = k // 2, k // 2 - (1 - k % 2)
        return F.pad(x, (before, after, before, after)) if k > 1 else x

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """x, h [B, H, W, C] -> the next hidden state [B, H, W, C]."""
        combined = _nchw(torch.cat([x, h], dim=-1))
        gates = torch.sigmoid(self.conv_gates(self._same(combined)))
        reset, update = _nhwc(gates).chunk(2, dim=-1)
        cand_in = _nchw(torch.cat([x, reset * h], dim=-1))
        cand = _nhwc(torch.tanh(self.conv_can(self._same(cand_in))))
        return (1.0 - update) * h + update * cand


class ConvGRUCellOutput(nn.Module):
    """A ConvGRUCell and a 1 x 1 output conv of its new hidden state."""

    def __init__(self, hidden_dim: int, output_dim: int, kernel: int = 2):
        super().__init__()
        self.cell = ConvGRUCell(hidden_dim, hidden_dim, kernel)
        self.output_conv = nn.Conv2d(hidden_dim, output_dim, 1)

    def forward(self, x: torch.Tensor, h: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x, h [B, H, W, C] -> (h', out), each [B, H, W, C]."""
        h_next = self.cell(x, h)
        return h_next, _nhwc(self.output_conv(_nchw(h_next)))
