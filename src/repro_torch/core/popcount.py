"""Popcount algorithm zoo (port of ``repro.core.popcount``).

The functional, bit-exact popcount building blocks the engines are made
of: the pairwise adder tree, bit packing, the SWAR word popcount, the
signed TM vote count and the tournament argmax.

**Word layout.** Packed words are ``int32`` tensors holding the same 32
bits as the JAX package's ``uint32`` words (little-endian bit order
within a word): torch has no ``~``/``>>``/``<<`` for ``uint32`` on the
CPU.  Compare against JAX with ``tensor.numpy().view(np.uint32)``; the
CUDA kernels read the same storage as ``const uint32_t*``.  The SWAR
sequence stays exact on ``int32`` with arithmetic shifts because every
shift is masked and the final ``>> 24`` leaves at most 32.
"""

from __future__ import annotations

import torch

__all__ = ["popcount_adder_tree", "popcount_swar", "signed_vote_count",
           "pack_bits", "unpack_bits", "argmax_tournament", "int_matmul"]


def popcount_adder_tree(bits: torch.Tensor) -> torch.Tensor:
    """Pairwise binary adder tree over the last axis → int32.

    Pads to the next power of two with zeros; depth ``ceil(log2 n)``,
    the structure of the generic FPGA popcount.
    """
    x = bits.to(torch.int32)
    n = x.shape[-1]
    size = 1 if n == 0 else 1 << max(0, n - 1).bit_length()
    if size != n:
        x = torch.nn.functional.pad(x, (0, size - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a trailing axis of {0,1} into int32 words (little-endian).

    ``(..., n)`` → ``(..., ceil(n/32))``; each word holds the bits of the
    JAX package's ``uint32`` word.
    """
    n = bits.shape[-1]
    n_words = -(-n // 32)
    b = bits.to(torch.int64)
    if n_words * 32 != n:
        b = torch.nn.functional.pad(b, (0, n_words * 32 - n))
    b = b.reshape(*bits.shape[:-1], n_words, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (b << shifts).sum(-1)                # [0, 2^32) in int64
    # wrap to the int32 holding the same 32 bits
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``(..., n_words)`` → ``(..., n)`` int8."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32)[..., :n] \
        .to(torch.int8)


def _swar_word(v: torch.Tensor) -> torch.Tensor:
    """Hacker's Delight popcount of each 32-bit lane of an int32 tensor."""
    v = v.to(torch.int32)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v * 0x01010101) >> 24


def popcount_swar(words: torch.Tensor) -> torch.Tensor:
    """Popcount of bit-packed words: ``(..., n_words)`` → ``(...)`` int32."""
    return _swar_word(words).sum(-1, dtype=torch.int32)


def signed_vote_count(bits: torch.Tensor, polarity: torch.Tensor
                      ) -> torch.Tensor:
    """TM class sum: ``sum(bits * where(polarity>0, +1, -1))`` over the
    last axis → int32 (``polarity`` broadcastable to ``bits``)."""
    sign = torch.where(polarity > 0, 1, -1).to(torch.int32)
    return (bits.to(torch.int32) * sign).sum(-1, dtype=torch.int32)


def argmax_tournament(scores: torch.Tensor) -> torch.Tensor:
    """Tournament-tree argmax over the last axis (ties → lowest index),
    ``ceil(log2 C)`` pairwise levels like the paper's arbiter tree →
    int32 indices, as in the JAX package."""
    c = scores.shape[-1]
    size = 1 if c == 0 else 1 << max(0, c - 1).bit_length()
    if scores.dtype.is_floating_point:
        low = float("-inf")
    else:
        low = torch.iinfo(scores.dtype).min
    if size != c:
        scores = torch.nn.functional.pad(scores, (0, size - c), value=low)
    idx = torch.arange(size, dtype=torch.int32,
                       device=scores.device).expand(scores.shape)
    while scores.shape[-1] > 1:
        a, b = scores[..., 0::2], scores[..., 1::2]
        ia, ib = idx[..., 0::2], idx[..., 1::2]
        take_a = a >= b          # ties resolve to the lower index
        scores = torch.where(take_a, a, b)
        idx = torch.where(take_a, ia, ib)
    return idx[..., 0]


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matrix product → int32.

    int32 on the CPU.  torch has no integer GEMM on CUDA, so there the
    product runs in float64, exact while every partial sum stays below
    2^53 — always, for the {0,1} and ±1 operands of this package.
    """
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32)
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)
