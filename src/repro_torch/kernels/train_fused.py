"""Kernel K2: fused Type I/II feedback deltas and the per-class scatter
(port of ``repro.kernels.train_fused``).

    cl_t[b,m]  = (Σ_l inc_t[b,m,l] · (1 − lit[b,l])) == 0    (clause eval)
    d1         = TypeI(cl_t, lit, bits1)                     (bitwise)
    d2         = TypeII(cl_t, lit, inc_t)
    delta_t    = where(m1_t, d1, 0) + where(m2_t, d2, 0)
    upd[y[b]] += delta_t[b]                                  (segment-sum)

and the same for the sampled negative class with ``bits2``/``y_neg``.
The Type I randomness enters as raw threefry words: ``u < p`` on the
uniform ``u = (bits >> 9) · 2⁻²³`` is exactly ``(bits >> 9) <
uniform_threshold(p)``.

Replaces the Pallas kernel ``repro/kernels/train_fused.py:
train_deltas_pallas`` (bodies ``_train_deltas_kernel``, ``_delta_body``),
the core of the ``fused`` train step.

- :func:`train_deltas` — the JAX function's contract: raw words
  ``bits1``/``bits2`` (B, M, L) and gathered include masks in, (C, M, L)
  int32 out.  Plain PyTorch (:func:`_delta_body` + ``index_add_``).
- :func:`train_deltas_keyed` — what kernel K2 computes: the per-row keys
  (B, 2) instead of the words and the whole include mask (C, M, L)
  instead of its gathered rows.  It equals ``train_deltas(x,
  bits(k1s, (M, L)), bits(k2s, (M, L)), inc[y], inc[y_neg], ...)``.  On a
  CUDA tensor it launches ``csrc/train_deltas.cu`` once: a thread block
  cluster per clause evaluates the addressed clauses, splits the batch
  over groups of threads and draws each word in registers from its row
  key, so the two (B, M, L) word tensors the JAX path materialises are
  never written; on a CPU tensor it runs
  :func:`train_deltas_keyed_plain`.  Nothing falls back: a CUDA build or
  launch failure raises, and so does M·L ≥ 2³² (the kernel's threefry
  counters are 32 bits).

Bound on an H100 (see ``csrc/train_deltas.cu``): the threefry word
operations — about 76 integer operations per Type I word, one word per
(row, clause, literal) whose mask selects Type I — at 16.75 T/s on the
CUDA cores, against the bytes of the include mask, the literals and the
(C, M, L) int32 output.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import prng

__all__ = ["train_deltas", "train_deltas_keyed", "train_deltas_keyed_plain",
           "uniform_threshold", "feedback_polarity_masks", "DEFAULT_BLOCK_B",
           "DEFAULT_BLOCK_M"]

# The JAX package's Pallas tile sizes.  They have no effect in the port;
# the train engines carry them so a snapshot's engine options round-trip.
DEFAULT_BLOCK_B = 64
DEFAULT_BLOCK_M = 128


def feedback_polarity_masks(fb_t: torch.Tensor, fb_n: torch.Tensor,
                            pos: torch.Tensor) -> tuple:
    """Route feedback activations to Type I/II by clause polarity:
    fb_t/fb_n (B, M) bool, pos (1, M) bool → ``(m1_t, m2_t, m1_n,
    m2_n)``.  The target class sends Type I to positive clauses and
    Type II to negative ones; the negative class swaps the roles."""
    return fb_t & pos, fb_t & ~pos, fb_n & ~pos, fb_n & pos


def uniform_threshold(p: float) -> int:
    """The threshold ``t`` with ``bits >> 9 < t`` ⟺ ``uniform(bits) < p``:
    ``ceil(f32(p) · 2²³)``, exact for every ``p`` (both sides are
    exactly representable in float32)."""
    return int(math.ceil(float(np.float32(p)) * (1 << 23)))


def _delta_body(lit, bits1, bits2, inc_t, inc_n, m1_t, m2_t, m1_n, m2_n,
                *, t_inc, t_dec):
    """Per-sample Type I/II deltas, the Pallas tile body's arithmetic.

    lit (B, L) {0,1}; bits1/bits2 (B, M, L) int32 words; inc_t/inc_n
    (B, M, L) {0,1}; m*_* (B, M) bool → (d_t, d_n), each (B, M, L) int16
    in {−1, 0, 1}.
    """
    not_lit = (1 - lit.to(torch.int32))[:, None, :]
    cl_t = ((inc_t.to(torch.int32) * not_lit).sum(-1) == 0)[:, :, None]
    cl_n = ((inc_n.to(torch.int32) * not_lit).sum(-1) == 0)[:, :, None]
    lit0 = (lit == 0)[:, None, :]

    def type_i(cl, words):
        # (cl ∧ ¬lit) ∨ ¬cl simplifies to ¬cl ∨ ¬lit; words are int32
        # storage, so the logical >> 9 is an arithmetic one masked to the
        # low 23 bits
        m = (words >> 9) & 0x7FFFFF
        inc_r = cl & ~lit0 & (m < t_inc)
        dec = (~cl | lit0) & (m < t_dec)
        return inc_r.to(torch.int16) - dec.to(torch.int16)

    def type_ii(cl, inc):
        return (cl & lit0 & (inc == 0)).to(torch.int16)

    zero = torch.zeros((), dtype=torch.int16, device=lit.device)
    d_t = torch.where(m1_t[:, :, None], type_i(cl_t, bits1), zero) \
        + torch.where(m2_t[:, :, None], type_ii(cl_t, inc_t), zero)
    d_n = torch.where(m1_n[:, :, None], type_i(cl_n, bits2), zero) \
        + torch.where(m2_n[:, :, None], type_ii(cl_n, inc_n), zero)
    return d_t, d_n


def train_deltas(literals, bits1, bits2, inc_t, inc_n, m1_t, m2_t, m1_n,
                 m2_n, y, y_neg, *, n_classes: int, p_inc: float,
                 p_dec: float) -> torch.Tensor:
    """Fused Type I/II feedback deltas, summed per class over the batch.

    literals (B, L) {0,1} int8; bits1/bits2 (B, M, L) int32 — the raw
    target/negative Type I words; inc_t/inc_n (B, M, L) {0,1} — the
    addressed classes' include masks; m1_t/m2_t/m1_n/m2_n (B, M) bool;
    y/y_neg (B,) class indices → upd (C, M, L) int32.  ``p_inc`` is the
    Type I include probability (1 if boost_tpf else (s−1)/s), ``p_dec``
    the exclude probability 1/s.  Plain PyTorch on any device.
    """
    d_t, d_n = _delta_body(literals, bits1, bits2, inc_t, inc_n,
                           m1_t, m2_t, m1_n, m2_n,
                           t_inc=uniform_threshold(p_inc),
                           t_dec=uniform_threshold(p_dec))
    b, m, l = d_t.shape
    upd = torch.zeros((n_classes, m * l), dtype=torch.int32,
                      device=literals.device)
    upd.index_add_(0, torch.cat([y, y_neg]).to(torch.int64),
                   torch.cat([d_t, d_n]).reshape(2 * b, m * l)
                   .to(torch.int32))
    return upd.reshape(n_classes, m, l)


def train_deltas_keyed_plain(literals, keys1, keys2, include, m1_t, m2_t,
                             m1_n, m2_n, y, y_neg, *, n_classes: int,
                             p_inc: float, p_dec: float) -> torch.Tensor:
    """Kernel K2's arithmetic, plain: draw the (B, M, L) words from the
    row keys with :mod:`repro_torch.core.prng`, gather the addressed
    include rows, then :func:`train_deltas`."""
    m, l = include.shape[1:]
    return train_deltas(literals, prng.bits(keys1, (m, l)),
                        prng.bits(keys2, (m, l)), include[y],
                        include[y_neg], m1_t, m2_t, m1_n, m2_n, y, y_neg,
                        n_classes=n_classes, p_inc=p_inc, p_dec=p_dec)


def _check(literals, keys1, keys2, include, masks, y, y_neg, n_classes):
    b, l = literals.shape
    c, m = include.shape[:2]
    want = {"literals": ((b, l), (torch.int8,)),
            "keys1": ((b, 2), (torch.int32,)),
            "keys2": ((b, 2), (torch.int32,)),
            "include": ((c, m, l), (torch.int8,)),
            "y": ((b,), (torch.int32, torch.int64)),
            "y_neg": ((b,), (torch.int32, torch.int64))}
    got = {"literals": literals, "keys1": keys1, "keys2": keys2,
           "include": include, "y": y, "y_neg": y_neg}
    for i, mask in enumerate(masks):
        want[f"mask{i}"] = ((b, m), (torch.bool,))
        got[f"mask{i}"] = mask
    for name, t in got.items():
        shape, dtypes = want[name]
        if tuple(t.shape) != shape or t.dtype not in dtypes:
            raise ValueError(f"{name} must be {shape} "
                             f"{'/'.join(map(str, dtypes))}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != literals.device:
            raise ValueError(f"{name} is on {t.device}, literals on "
                             f"{literals.device}")
    if n_classes != c:
        raise ValueError(f"n_classes={n_classes} but include has {c} "
                         f"classes")


def train_deltas_keyed(literals, keys1, keys2, include, m1_t, m2_t, m1_n,
                       m2_n, y, y_neg, *, n_classes: int, p_inc: float,
                       p_dec: float) -> torch.Tensor:
    """literals (B, L) int8 {0,1}; keys1/keys2 (B, 2) int32 per-row
    threefry keys; include (C, M, L) int8 {0,1}; m1_t/m2_t/m1_n/m2_n
    (B, M) bool; y/y_neg (B,) int32 or int64 classes in [0, C) → upd
    (C, M, L) int32, equal to :func:`train_deltas` on the words the keys
    draw and the gathered include rows.

    CPU tensors: the plain version.  CUDA tensors: kernel K2, counted in
    ``kernel.launches.train_deltas``."""
    masks = (m1_t, m2_t, m1_n, m2_n)
    _check(literals, keys1, keys2, include, masks, y, y_neg, n_classes)
    if literals.device.type == "cpu":
        return train_deltas_keyed_plain(
            literals, keys1, keys2, include, *masks, y, y_neg,
            n_classes=n_classes, p_inc=p_inc, p_dec=p_dec)
    if literals.device.type != "cuda":
        raise ValueError(f"train_deltas_keyed runs on cpu or cuda, not "
                         f"{literals.device}")
    from .ops import launch
    b, l = literals.shape
    c, m = include.shape[:2]
    dev = literals.device
    out = torch.empty((c, m, l), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    if b == 0:
        return out.zero_()
    # the kernel reads y / y_neg as int32 or int64, whichever they share
    if y_neg.dtype != y.dtype:
        y_neg = y_neg.to(y.dtype)
    tensors = (literals, keys1, keys2, include, *masks, y, y_neg)
    tensors = tuple(t.contiguous() for t in tensors)
    launch("train_deltas", (*tensors, out),
           (b, c, m, l, y.element_size(), uniform_threshold(p_inc),
            uniform_threshold(p_dec)))
    return out
