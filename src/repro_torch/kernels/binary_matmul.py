"""Kernel K6: ±1 GEMM, the BNN xnor-popcount accumulation (port of
``repro.kernels.binary_matmul``).

    out[m,n] = Σ_k x[m,k] · w[k,n]  =  2·popcount(xnor(x_bits, w_bits)) − K

Replaces the Pallas kernel ``repro/kernels/binary_matmul.py:
binary_matmul_pallas`` (body ``_binary_matmul_kernel``).  On a CUDA
tensor :func:`binary_matmul` launches the hand-written kernel in
``csrc/binary_matmul.cu`` (64 × 64 output tiles, int8 products with
``__dp4a``, int32 accumulation); on a CPU tensor it runs the plain
version :func:`repro_torch.kernels.ref.ref_binary_matmul`.  Nothing falls
back: a CUDA build or launch failure raises.

The Pallas kernel accumulates in float32, exact for ±1 operands while
K < 2²⁴; the kernel and its plain version accumulate integers, exact
for any int8 operands and any K, so all three agree bit for bit.

Bound on an H100 at the ``kernel_bench`` shape 1024³: 6.29 MB of
operands and output (1.88 µs at 3.35 TB/s) against 2.15 G int8
operations (1.09 µs at the tensor cores' 1,979 TOP/s) — bound by bytes.
"""

from __future__ import annotations

import torch

from .ref import ref_binary_matmul

__all__ = ["binary_matmul", "binary_matmul_plain"]

binary_matmul_plain = ref_binary_matmul


def binary_matmul(x_pm1: torch.Tensor, w_pm1: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 ±1 × (K, N) int8 ±1 → (M, N) int32, exact.

    CPU tensors: the plain version.  CUDA tensors: kernel K6, counted in
    ``binary_matmul.launches``."""
    for name, t in (("x_pm1", x_pm1), ("w_pm1", w_pm1)):
        if t.dtype != torch.int8 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D int8 tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if w_pm1.device != x_pm1.device:
        raise ValueError(f"w_pm1 is on {w_pm1.device}, x_pm1 on "
                         f"{x_pm1.device}")
    if x_pm1.shape[1] != w_pm1.shape[0]:
        raise ValueError(f"inner dimensions differ: x_pm1 "
                         f"{tuple(x_pm1.shape)}, w_pm1 {tuple(w_pm1.shape)}")
    if x_pm1.device.type == "cpu":
        return binary_matmul_plain(x_pm1, w_pm1)
    if x_pm1.device.type != "cuda":
        raise ValueError(f"binary_matmul runs on cpu or cuda, not "
                         f"{x_pm1.device}")
    for name, t in (("x_pm1", x_pm1), ("w_pm1", w_pm1)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from .ops import launch
    (m, k), n = x_pm1.shape, w_pm1.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=x_pm1.device)
    if m == 0 or n == 0:
        return out
    launch("binary_matmul", (x_pm1, w_pm1, out), (m, n, k))
    binary_matmul.launches += 1
    return out


binary_matmul.launches = 0
