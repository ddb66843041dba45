"""Plain PyTorch version of the gradient-sketch projection — the port
of ``repro.kernels.grad_sketch.ref`` and of the sign hash of
``repro.kernels.grad_sketch.kernel`` (``_sign_bits``, ``sign_block``).

G (n, P) is projected through a ±1 matrix S (P, d) whose entries are a
pure function of (seed, offset + p, j): a wrap-around uint32 hash with
the reference's mixing constants. Torch has no uint32 arithmetic on
every device, and its int32 ``>>`` is arithmetic, so the hash runs in
int64 holding values in [0, 2³²): shifts are then logical, and each
multiply by a 32-bit constant is split into 16-bit halves so that no
product reaches 2⁶³. The signs are bitwise the reference's; the sketch
sums in another order than the CUDA kernel and XLA, so it agrees with
them to a tolerance, not to the bit.
"""
from __future__ import annotations

import torch

# the reference's xxhash/murmur-style mixing constants
# (``repro.kernels.grad_sketch.kernel.MIX_CONSTANTS``), also used by
# ``repro_torch.core.relevance.fold_seed``
MIX_CONSTANTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D)
_P1, _P2, _P3 = MIX_CONSTANTS
MASK32 = 0xFFFFFFFF
TILE = 4096                  # positions per materialised sign block


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 x in [0, 2³²) and a 32-bit constant c,
    with every intermediate below 2⁴⁹."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def sign_bits(seed: int, start: int, count: int, dim: int,
              device=None) -> torch.Tensor:
    """The raw sign bits ∈ {0, 1} (int64, (count, dim)) of positions
    start .. start + count - 1 and sketch dims 0 .. dim - 1. ``seed``
    and ``start`` are taken mod 2³², as the reference's uint32 casts
    take them (a negative int32 seed wraps)."""
    pos = torch.arange(count, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(dim, dtype=torch.int64, device=device)[None, :]
    x = ((int(start) & MASK32) + pos) & MASK32
    x = ((int(seed) & MASK32) + _mul32(x, _P1) + _mul32(j, _P2)) & MASK32
    x = _mul32(x ^ (x >> 15), _P2)
    x = _mul32(x ^ (x >> 13), _P3)
    x = x ^ (x >> 16)
    return x >> 31


def _hash_bits(seed: int, pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Sign bits (int64 ∈ {0, 1}, (len(pos), dim)) of the positions
    ``pos`` (int64, any values; taken mod 2³²)."""
    j = torch.arange(dim, dtype=torch.int64, device=pos.device)[None, :]
    x = (pos[:, None] & MASK32)
    x = ((int(seed) & MASK32) + _mul32(x, _P1) + _mul32(j, _P2)) & MASK32
    x = _mul32(x ^ (x >> 15), _P2)
    x = _mul32(x ^ (x >> 13), _P3)
    x = x ^ (x >> 16)
    return x >> 31


def shard_positions(start: int, count: int, offset: int, stride: int,
                    c0: int, width: int, device=None) -> torch.Tensor:
    """The full leaf's positions of local elements start .. start + count
    − 1 of a shard: offset + (q // width) · stride + c0 + q % width."""
    q = torch.arange(start, start + count, dtype=torch.int64, device=device)
    return int(offset) + (q // width) * stride + c0 + q % width


def sign_block(seed: int, start: int, count: int, dim: int,
               device=None) -> torch.Tensor:
    """±1 fp32 block S[p - start, j] for positions p in [start, start +
    count) and dims j < dim."""
    bits = sign_bits(seed, start, count, dim, device)
    return 1.0 - 2.0 * bits.to(torch.float32)


def sketch_flat(G: torch.Tensor, seed: int, dim: int, offset: int = 0,
                tile: int = TILE, position_map=None) -> torch.Tensor:
    """G (n, P) → G · S (n, d) fp32 with S[p, j] = sign_block(seed,
    offset + p, ...), or, with ``position_map`` = (stride, c0, width) (a
    strided shard of a leaf), the signs of positions ``shard_positions``.
    S is materialised ``tile`` positions at a time, and each tile's
    product is added to the sum in order. Each row's product is taken
    alone (a vector-matrix product): a matrix product's order of adds
    may change with the number of rows, and a row's sketch must not
    depend on which rows share the call (a rank of a device mesh
    projects its own agents' rows)."""
    n, p = G.shape
    acc = torch.zeros((n, dim), dtype=torch.float32, device=G.device)
    for start in range(0, p, tile):
        width = min(tile, p - start)
        if position_map is None:
            S = sign_block(seed, offset + start, width, dim, G.device)
        else:
            pos = shard_positions(start, width, offset, *position_map,
                                  device=G.device)
            S = 1.0 - 2.0 * _hash_bits(seed, pos, dim).to(torch.float32)
        part = G[:, start:start + width].to(torch.float32)
        acc = acc + torch.stack([row @ S for row in part])
    return acc
