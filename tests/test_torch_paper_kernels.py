"""Port parity for the paper-surface kernels K4, K5 and K6: each plain
version (what the wrapper runs on a CPU tensor) against the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs.

- K4 ``popcount_words`` and K6 ``binary_matmul``: bitwise.
- K5 ``pdl_race``: bitwise on integer-valued delays (exact in any
  summation order); on float delays ``latency`` within rtol 1e-6 (XLA and
  torch sum the M delays in different orders) and ``winner`` /
  ``metastable`` exact where no two arrivals, and no gap and ``t_res``,
  lie within 1e-3 ps.  A tied minimum is pinned to the Pallas kernel's
  semantics (gap to the next distinct arrival); the port's
  ``ref_pdl_race`` is pinned to JAX's oracle (``top_k``, gap 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.binary_matmul import binary_matmul_pallas
from repro.kernels.pdl_race import pdl_race_pallas
from repro.kernels.popcount import popcount_words_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.binary_matmul import (binary_matmul,
                                               binary_matmul_plain)
from repro_torch.kernels.pdl_race import pdl_race, pdl_race_plain
from repro_torch.kernels.popcount import popcount_words, popcount_words_plain

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)


def _words(rng, r, w):
    return rng.integers(0, 2**32, (r, w), dtype=np.uint32)


def _t(a):
    """numpy uint32 words → the port's int32 words (same bits)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


# --- K4 ----------------------------------------------------------------

@pytest.mark.parametrize("r,w", [(1, 1), (3, 5), (8, 128), (17, 33),
                                 (65, 128), (37, 129)])
def test_popcount_plain_matches_pallas(r, w):
    words = _words(np.random.default_rng(r * 1000 + w), r, w)
    want = np.asarray(popcount_words_pallas(jnp.asarray(words)))
    got = popcount_words(_t(words))
    assert got.dtype == torch.int32 and got.shape == (r,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.ref_popcount_words(_t(words)).numpy(),
                                  want)


def test_popcount_all_ones_and_all_zero_rows():
    words = np.zeros((4, 33), np.uint32)
    words[1] = 0xFFFFFFFF
    words[3, ::2] = 0xFFFFFFFF
    want = np.asarray(popcount_words_pallas(jnp.asarray(words)))
    np.testing.assert_array_equal(want, [0, 32 * 33, 0, 32 * 17])
    np.testing.assert_array_equal(popcount_words(_t(words)).numpy(), want)


# --- K6 ----------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (7, 33, 5), (1, 784, 128),
                                   (37, 129, 65), (200, 300, 100)])
def test_binary_matmul_plain_matches_pallas(m, k, n):
    rng = np.random.default_rng(m + 10 * k + 100 * n)
    x = rng.choice([-1, 1], (m, k)).astype(np.int8)
    w = rng.choice([-1, 1], (k, n)).astype(np.int8)
    want = np.asarray(binary_matmul_pallas(jnp.asarray(x), jnp.asarray(w)))
    got = binary_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.ref_binary_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jref.ref_binary_matmul(jnp.asarray(x), jnp.asarray(w))))


def test_binary_matmul_equals_xnor_popcount():
    """±1 GEMM == 2·popcount(xnor) − K on the bit encoding (Fig. 1(b))."""
    rng = np.random.default_rng(3)
    k = 96
    xb, wb = rng.integers(0, 2, (5, k)), rng.integers(0, 2, (k, 7))
    got = binary_matmul(torch.from_numpy((2 * xb - 1).astype(np.int8)),
                        torch.from_numpy((2 * wb - 1).astype(np.int8)))
    xnor_pop = (xb[:, :, None] == wb[None, :, :]).sum(1)
    np.testing.assert_array_equal(got.numpy(), 2 * xnor_pop - k)


# --- K5 ----------------------------------------------------------------

def _race_inputs(rng, b, c, m, *, integer):
    sel = rng.integers(0, 2, (b, c, m), dtype=np.int8)
    if integer:
        ed = rng.integers(300, 700, (c, m, 2)).astype(np.float32)
        skew = rng.integers(-3, 4, (c,)).astype(np.float32)
    else:
        ed = rng.normal([[[384.5, 617.6]]], 5.0, (c, m, 2)).astype(np.float32)
        skew = rng.normal(0, 1, (c,)).astype(np.float32)
    return sel, ed, skew


def _pallas(sel, ed, skew, t_res):
    return [np.asarray(a) for a in pdl_race_pallas(
        jnp.asarray(sel), jnp.asarray(ed), jnp.asarray(skew), t_res)]


def _port(fn, sel, ed, skew, t_res):
    return [a.numpy() for a in fn(torch.from_numpy(sel), torch.from_numpy(ed),
                                  torch.from_numpy(skew), t_res)]


@pytest.mark.parametrize("b,c,m", [(1, 1, 3), (1, 2, 3), (3, 3, 10),
                                   (16, 10, 100), (9, 5, 37), (37, 10, 50)])
def test_pdl_race_plain_matches_pallas_integer_delays(b, c, m):
    """Integer-valued delays sum exactly in any order: all three outputs
    bitwise, ties between classes included (they are frequent here)."""
    sel, ed, skew = _race_inputs(np.random.default_rng(b * c + m), b, c, m,
                                 integer=True)
    want = _pallas(sel, ed, skew, 10.0)
    got = _port(pdl_race, sel, ed, skew, 10.0)
    assert [g.dtype for g in got] == [np.int32, np.float32, np.bool_]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("b,c,m", [(3, 3, 10), (16, 10, 100), (9, 5, 37)])
def test_pdl_race_plain_matches_pallas_float_delays(b, c, m):
    sel, ed, skew = _race_inputs(np.random.default_rng(100 + b * c + m),
                                 b, c, m, integer=False)
    t_res = 10.0
    want_w, want_l, want_m = _pallas(sel, ed, skew, t_res)
    got_w, got_l, got_m = _port(pdl_race_plain, sel, ed, skew, t_res)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-6)
    # exact away from near-ties, judged on float64 delays
    d = np.where(sel == 1, ed[None, :, :, 0], ed[None, :, :, 1]) \
        .astype(np.float64).sum(-1) + skew
    srt = np.sort(d, -1)
    gaps = np.diff(srt, axis=-1)
    clear = (gaps.min(-1) > 1e-3) & (np.abs(gaps[:, 0] - t_res) > 1e-3)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got_w[clear], want_w[clear])
    np.testing.assert_array_equal(got_m[clear], want_m[clear])


def _tied_minimum():
    """Classes 0 and 1 arrive together at 4 ps, class 2 at 400 ps."""
    sel = np.ones((1, 3, 1), np.int8)
    ed = np.array([[[4.0, 4.0]], [[4.0, 4.0]], [[400.0, 400.0]]], np.float32)
    return sel, ed, np.zeros((3,), np.float32)


def test_pdl_race_tied_minimum_follows_the_pallas_kernel():
    """The kernel measures the gap to the next *distinct* arrival (396 ps
    here, not metastable); its oracle's top_k gap is 0 (metastable).  K5
    follows the kernel; the port's ref_pdl_race follows the oracle."""
    sel, ed, skew = _tied_minimum()
    pallas = _pallas(sel, ed, skew, 10.0)
    oracle = [np.asarray(a) for a in jref.ref_pdl_race(
        jnp.asarray(sel), jnp.asarray(ed), jnp.asarray(skew), 10.0)]
    assert pallas[0][0] == 0 and not pallas[2][0]
    assert oracle[0][0] == 0 and oracle[2][0]
    for g, w in zip(_port(pdl_race, sel, ed, skew, 10.0), pallas):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(_port(ref.ref_pdl_race, sel, ed, skew, 10.0), oracle):
        np.testing.assert_array_equal(g, w)


def test_pdl_race_all_equal_and_single_class_give_gap_zero():
    """Every class at the minimum (or C = 1): gap 0, metastable for any
    positive t_res, winner 0 — in the Pallas kernel and in K5's plain
    version alike."""
    for c in (1, 4):
        sel = np.zeros((2, c, 3), np.int8)
        ed = np.full((c, 3, 2), 7.0, np.float32)
        skew = np.zeros((c,), np.float32)
        want = _pallas(sel, ed, skew, 0.5)
        np.testing.assert_array_equal(want[2], [True, True])
        for g, w in zip(_port(pdl_race, sel, ed, skew, 0.5), want):
            np.testing.assert_array_equal(g, w)


def test_ref_pdl_race_matches_jax_oracle():
    sel, ed, skew = _race_inputs(np.random.default_rng(11), 16, 10, 100,
                                 integer=True)
    want = [np.asarray(a) for a in jref.ref_pdl_race(
        jnp.asarray(sel), jnp.asarray(ed), jnp.asarray(skew), 10.0)]
    for g, w in zip(_port(ref.ref_pdl_race, sel, ed, skew, 10.0), want):
        np.testing.assert_array_equal(g, w)


# --- the wrappers ------------------------------------------------------

def test_wrappers_validate_and_launch_nothing_on_cpu():
    before = (popcount_words.launches, pdl_race.launches,
              binary_matmul.launches)
    popcount_words(torch.zeros((2, 3), dtype=torch.int32))
    binary_matmul(torch.ones((2, 3), dtype=torch.int8),
                  torch.ones((3, 4), dtype=torch.int8))
    pdl_race(torch.zeros((2, 3, 4), dtype=torch.int8),
             torch.ones((3, 4, 2)), torch.zeros(3), 1.0)
    assert (popcount_words.launches, pdl_race.launches,
            binary_matmul.launches) == before
    assert popcount_words_plain is ref.ref_popcount_words
    assert binary_matmul_plain is ref.ref_binary_matmul
    with pytest.raises(ValueError, match="int32"):
        popcount_words(torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="inner dimensions"):
        binary_matmul(torch.ones((2, 3), dtype=torch.int8),
                      torch.ones((4, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="elem_delays"):
        pdl_race(torch.zeros((2, 3, 4), dtype=torch.int8),
                 torch.ones((3, 5, 2)), torch.zeros(3), 1.0)
    with pytest.raises(ValueError, match="no classes"):
        pdl_race(torch.zeros((2, 0, 4), dtype=torch.int8),
                 torch.ones((0, 4, 2)), torch.zeros(0), 1.0)
