"""Kernel K4: row Hamming weight of bit-packed words (port of
``repro.kernels.popcount``).

    out[r] = Σ_w popcount(words[r, w])

Replaces the Pallas kernel ``repro/kernels/popcount.py:
popcount_words_pallas`` (body ``_popcount_kernel``).  On a CUDA tensor
:func:`popcount_words` launches the hand-written kernel in
``csrc/popcount_words.cu`` (a warp per row, ``__popc`` per word, a
shuffle reduction); on a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.ref_popcount_words` (the SWAR sequence).
Nothing falls back: a CUDA build or launch failure raises.

Words are int32 tensors holding the JAX package's uint32 bits (see
:mod:`repro_torch.core.popcount`); the kernel reads them as uint32.  The
count is exact, so kernel, plain version and the Pallas kernel agree bit
for bit.

Bound on an H100: the words are read once and the counts written once,
4·R·W + 4·R bytes — 8.39 MB at the ``kernel_bench`` shape 4096 × 512,
2.50 µs at 3.35 TB/s.
"""

from __future__ import annotations

import torch

from .ref import ref_popcount_words

__all__ = ["popcount_words", "popcount_words_plain"]

popcount_words_plain = ref_popcount_words


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """(R, W) int32 bit-packed rows → (R,) int32 Hamming weights.

    CPU tensors: the plain version.  CUDA tensors: kernel K4, counted in
    ``kernel.launches.popcount_words``."""
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"words must be a 2-D int32 tensor, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if words.device.type == "cpu":
        return popcount_words_plain(words)
    if words.device.type != "cuda":
        raise ValueError(f"popcount_words runs on cpu or cuda, not "
                         f"{words.device}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    from .ops import launch
    r, w = words.shape
    out = torch.empty((r,), dtype=torch.int32, device=words.device)
    if r == 0:
        return out
    launch("popcount_words", (words, out), (r, w))
    return out
