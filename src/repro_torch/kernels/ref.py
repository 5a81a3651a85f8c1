# Port of repro/kernels/ref.py: the LSTM cell oracle (the flash-attention
# and SSD oracles come with their kernels, ROADMAP queue 2).
"""Plain PyTorch oracles for the hand-written kernels."""
from __future__ import annotations

import torch


def lstm_cell_ref(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor):
    """x: (B, Dx); h, c: (B, Dh); w: (Dx+Dh, 4Dh); b: (4Dh,)."""
    z = torch.cat([x, h], dim=-1) @ w + b
    i, f, o, g = torch.chunk(z, 4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new
