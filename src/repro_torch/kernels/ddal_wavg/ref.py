"""Plain PyTorch versions of the eq. 4 share-step kernels.

They perform the CUDA kernels' float ops in the kernels' order — the
eq. 4 weights with left-to-right sums (``eq4_weights``), then
acc ← acc + w_j·G[j] for j = 0..m-1 in fp32, each a separately rounded
multiply and add — so on the card the kernel and its plain version
agree to the bit, and on the CPU the port's wrappers run these. They
repeat the kernel's arithmetic and are no yardstick of speed.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.weighting import eq4_weights, sequential_sum


def wavg(G: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ_j w_j·G[j] per agent: G (n, m, P), w (n, m) → (n, P) fp32."""
    acc = torch.zeros(G.shape[:-2] + G.shape[-1:], dtype=torch.float32,
                      device=G.device)
    for j in range(G.shape[-2]):
        acc = acc + w[..., j, None].to(torch.float32) * G[..., j, :]
    return acc


def fused_wavg(G: torch.Tensor, T: torch.Tensor, R: torch.Tensor,
               valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ḡ (n, P), Σw (n,)) from the raw metadata T, R, valid (n, m)."""
    w = eq4_weights(T, R, valid)
    return wavg(G, w), sequential_sum(w)
