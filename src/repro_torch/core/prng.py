"""Threefry2x32 counter-based PRNG, bit for bit as ``jax.random`` draws it.

The JAX package's training path takes every random number from
``jax.random`` with the default ``threefry2x32`` implementation under
``jax_threefry_partitionable=True`` (the default since jax 0.5).  That
generator is a pure function of (key, counter), so the port reproduces
it exactly:

- a **key** is its key data: a ``(..., 2)`` tensor of two 32-bit words,
  held as ``int32`` storage of the same bits (the port's word layout, see
  :mod:`repro_torch.core.popcount`); leading axes batch keys the way
  ``jax.vmap`` over a key array does;
- the counter of element ``i`` (flat row-major index) of a draw of
  ``shape`` is the word pair ``(i >> 32, i & 0xffffffff)``;
- :func:`bits` is ``out0 ^ out1`` of ``threefry2x32(key, counter)``;
  :func:`split` ``(key, n)[i]`` is the pair ``(out0, out1)`` at counter
  ``i`` (JAX's ``_threefry_split_foldlike``);
- :func:`uniform` turns the top 23 bits into a float32 in ``[1, 2)`` and
  subtracts 1; :func:`randint` follows ``jax.random.randint``'s two-word
  modular reduction;
- :func:`normal` is ``√2 · erfinv(u)`` of a uniform ``u`` in
  ``(-1, 1)``, with XLA's float32 ``erfinv`` polynomial (Giles 2010)
  evaluated step for step: the draws agree with ``jax.random.normal`` to
  a few float32 ulps (XLA's ``log1p`` is its own approximation), not bit
  for bit.

The arithmetic runs on ``int64`` tensors masked to 32 bits (torch has no
``>>``/``<<`` for ``uint32`` on the CPU, and ``int32`` overflow is not a
contract); results go back as ``int32`` words.  Everything runs on the
device of the key it is given.

:func:`key` matches ``jax.random.key`` as the JAX package runs it, with
64-bit types off: the seed is taken modulo 2³², so its key data is
``(0, seed mod 2³²)``.  Only ``threefry2x32`` is supported: XLA's
``rbg`` generator cannot be reproduced (ROADMAP.md), and asking for it
raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["IMPL", "threefry2x32", "key", "split", "bits", "uniform",
           "randint", "normal", "wrap_key_data", "key_data"]

IMPL = "threefry2x32"
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# XLA's float32 erfinv (xla/client/lib/math.cc, ErfInv32): Horner
# coefficients for w = -log1p(-x²) below 5 and from 5 up
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _check_impl(impl: str) -> None:
    if impl != IMPL:
        raise NotImplementedError(
            f"PRNG impl {impl!r}: the port reproduces only {IMPL!r} "
            f"(XLA's RngBitGenerator behind 'rbg' cannot be reproduced; "
            f"see ROADMAP.md)")


def _u64(words: torch.Tensor) -> torch.Tensor:
    """int32 word storage → int64 holding the unsigned value."""
    return words.to(torch.int64) & _MASK


def _i32(values: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2³²) → the int32 holding the same 32 bits."""
    return torch.where(values >= 2**31, values - 2**32, values) \
        .to(torch.int32)


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher, 20 rounds (Salmon et al. 2011, as
    ``jax._src.prng.threefry2x32_p``): key words ``k0``/``k1`` and counter
    words ``x0``/``x1``, int64 tensors holding unsigned 32-bit values,
    broadcast together → ``(out0, out1)``, the same."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int, *, impl: str = IMPL, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s key data as a ``(2,)`` int32 tensor."""
    _check_impl(impl)
    data = torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)
    return _i32(data)


def wrap_key_data(data, *, impl: str = IMPL) -> torch.Tensor:
    """``jax.random.wrap_key_data``: raw ``(..., 2)`` key words (a tensor
    or any integer array, e.g. JAX's ``uint32`` key data) → the port's
    key, a ``(..., 2)`` int32 tensor of the same bits."""
    _check_impl(impl)
    if isinstance(data, torch.Tensor):
        t = data
    else:
        t = torch.from_numpy(np.asarray(data).astype(np.int64))
    if t.dim() == 0 or t.shape[-1] != 2:
        raise ValueError(f"threefry2x32 key data must have a trailing axis "
                         f"of 2 words, got shape {tuple(t.shape)}")
    return _i32(t.to(torch.int64) & _MASK)


def key_data(keys: torch.Tensor) -> np.ndarray:
    """``jax.random.key_data``: the raw words of ``keys`` as a ``uint32``
    numpy array (what a JAX key's ``key_data`` holds)."""
    return keys.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def _counters(shape: tuple[int, ...], device) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    n = 1
    for d in shape:
        n *= int(d)
    i = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return i >> 32, i & _MASK


def _draw(keys: torch.Tensor, shape: tuple[int, ...]
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of every key in ``keys`` (..., 2) at the counters of
    a ``shape`` draw → (out0, out1), each (..., *shape) int64."""
    shape = tuple(int(d) for d in shape)
    k = _u64(keys)
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(tuple(lead) + (1,) * len(shape))
    k1 = k[..., 1].reshape(tuple(lead) + (1,) * len(shape))
    c0, c1 = _counters(shape, keys.device)
    return threefry2x32(k0, k1, c0, c1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` keys → ``(..., num, 2)`` keys."""
    out0, out1 = _draw(keys, (num,))
    return _i32(torch.stack([out0, out1], dim=-1))


def _bits64(keys: torch.Tensor, shape) -> torch.Tensor:
    out0, out1 = _draw(keys, tuple(shape))
    return out0 ^ out1


def bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` → int32 words of the same
    bits, shape ``(..., *shape)`` for ``(..., 2)`` keys (a batch of keys
    draws like ``vmap(bits)``)."""
    return _i32(_bits64(keys, shape))


def uniform(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in ``[0, 1)`` from the
    top 23 bits of each word, ``(..., *shape)`` for ``(..., 2)`` keys."""
    mant = (_bits64(keys, shape) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def randint(keys: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32, Python
    int bounds): two words per value from ``split(key)``, reduced modulo
    the span in wrapping uint32 arithmetic as JAX does — the multiplier
    is ``((2¹⁶ mod span)² mod 2³²) mod span``."""
    span = maxval - minval if maxval > minval else 1
    k = split(keys, 2)
    higher = _bits64(k[..., 0, :], shape)
    lower = _bits64(k[..., 1, :], shape)
    mult = (((2**16 % span) ** 2) & _MASK) % span
    offset = (((higher % span) * mult) & _MASK) + lower % span
    return (minval + (offset & _MASK) % span).to(torch.int32)


def _fma32(a, b, c) -> torch.Tensor:
    """``a·b + c`` rounded once to float32 — what XLA computes where it
    contracts a float32 multiply feeding an add into a fused
    multiply-add.  Evaluated in float64, where the product of two
    float32 values is exact; Python floats are rounded to float32 first,
    as JAX's weak types are."""
    def f64(v):
        if isinstance(v, torch.Tensor):
            return v.to(torch.float64)
        return float(np.float32(v))
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` on float32 ``x`` in ``(-1, 1)`` (what
    :func:`normal` passes; XLA's ``±1`` edge case is never reached): the
    degree-8 polynomial in ``w = -log1p(-x²)`` (or ``√w - 3`` from
    ``w = 5`` up) times ``x``, each Horner step one fused multiply-add."""
    dev = x.device
    xx = x * x
    w = (-torch.log1p(-xx.to(torch.float64))).to(torch.float32)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=dev),
                           torch.tensor(_ERFINV_GE5[i], device=dev))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma32(p, w, coef(i))
    return p * x


def normal(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32) to a few ulps:
    ``√2 · erfinv(u)`` with ``u`` uniform in ``[nextafter(-1, 0), 1)``
    from the same threefry words, ``(..., *shape)`` for ``(..., 2)``
    keys.  The uniform is bit for bit JAX's; the erfinv polynomial is
    XLA's (see the module docstring for why it is not bitwise)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(keys, shape)
    # u·(1 - lo) + lo with the span rounded to float32 (2.0): exact
    u = torch.clamp(u * 2.0 + lo, min=lo)
    return float(np.float32(np.sqrt(2.0))) * _erfinv32(u)
