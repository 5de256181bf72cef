"""Port parity: ``repro_torch.core`` against ``repro.core``, bit for bit.

Inputs come from numpy seeds and go through the JAX function and its
PyTorch counterpart; every output is an integer, so the tolerance is 0.
Packed words are compared through ``.numpy().view(np.uint32)``: the port
carries the JAX package's uint32 bits in int32 tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import popcount as jpop
from repro.core import tm as jtm
from repro_torch.convert import state_from_numpy
from repro_torch.core import popcount as tpop
from repro_torch.core import tm as ttm

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

SHAPES = [(2, 6, 9), (3, 10, 12), (4, 8, 40), (1, 3, 1)]


def _random_tm(c, m, f, *, density=0.15, seed=0, batch=17):
    """numpy ta + literals, built like tests/test_engine.py::_random_tm."""
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random((c, m, 2 * f)) < density, 129, 128) \
        .astype(np.int32)
    lits = rng.integers(0, 2, (batch, 2 * f), dtype=np.int8)
    return ta, lits


def _words(rng, shape):
    """Random 32-bit words as uint32 (JAX) and the same bits as int32."""
    u = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    u.flat[:4] = [0, 0xFFFFFFFF, 0x80000001, 7][:u.size]
    return u, torch.from_numpy(u.view(np.int32).copy())


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 64, 100])
def test_pack_unpack_bits(n):
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, (3, 4, n), dtype=np.int8)
    ref = np.asarray(jpop.pack_bits(jnp.asarray(bits)))
    got = tpop.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    back = tpop.unpack_bits(got, n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpop.unpack_bits(jnp.asarray(ref), n)))
    np.testing.assert_array_equal(back.numpy(), bits)


@pytest.mark.parametrize("seed", range(3))
def test_swar_word_and_popcount_swar(seed):
    u, t = _words(np.random.default_rng(seed), (6, 9))
    np.testing.assert_array_equal(
        tpop._swar_word(t).numpy(), np.asarray(jpop._swar_word(jnp.asarray(u))))
    np.testing.assert_array_equal(
        tpop.popcount_swar(t).numpy(),
        np.asarray(jpop.popcount_swar(jnp.asarray(u))))
    np.testing.assert_array_equal(tpop._swar_word(t[0, :4]).numpy(),
                                  [0, 32, 2, 3])


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
def test_popcount_adder_tree(n):
    bits = np.random.default_rng(n).integers(0, 2, (5, n), dtype=np.int8)
    np.testing.assert_array_equal(
        tpop.popcount_adder_tree(torch.from_numpy(bits)).numpy(),
        np.asarray(jpop.popcount_adder_tree(jnp.asarray(bits))))


@pytest.mark.parametrize("m", [1, 6, 7])
def test_signed_vote_count(m):
    rng = np.random.default_rng(m)
    bits = rng.integers(0, 2, (4, 3, m), dtype=np.int8)
    pol = np.where(rng.random(m) < 0.5, 1, -1).astype(np.int32)
    np.testing.assert_array_equal(
        tpop.signed_vote_count(torch.from_numpy(bits),
                               torch.from_numpy(pol)).numpy(),
        np.asarray(jpop.signed_vote_count(jnp.asarray(bits),
                                          jnp.asarray(pol))))


@pytest.mark.parametrize("c", [1, 2, 3, 5, 8, 10])
def test_argmax_tournament_ties_lowest(c):
    rng = np.random.default_rng(c)
    scores = rng.integers(-3, 3, (40, c), dtype=np.int32)   # many ties
    got = tpop.argmax_tournament(torch.from_numpy(scores))
    ref = np.asarray(jpop.argmax_tournament(jnp.asarray(scores)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), np.argmax(scores, -1))
    fl = rng.standard_normal((6, c)).astype(np.float32)
    np.testing.assert_array_equal(
        tpop.argmax_tournament(torch.from_numpy(fl)).numpy(),
        np.argmax(fl, -1))


def test_int_matmul_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(-2, 3, (5, 7), dtype=np.int8)
    b = rng.integers(-2, 3, (7, 3), dtype=np.int8)
    got = tpop.int_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int32) @ b.astype(np.int32))


@pytest.mark.parametrize("m", [1, 4, 7])
def test_clause_polarity(m):
    np.testing.assert_array_equal(ttm.clause_polarity(m).numpy(),
                                  np.asarray(jtm.clause_polarity(m)))


@pytest.mark.parametrize("density", [0.0, 0.15, 1.0])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "C{}M{}F{}".format(*s))
def test_tm_inference_chain(shape, density):
    """include_mask → clause_outputs (both empty-clause modes) →
    class_sums → predict, each against the JAX function."""
    c, m, f = shape
    ta, lits = _random_tm(c, m, f, density=density, seed=c * m + f)
    jcfg = jtm.TMConfig(n_classes=c, n_clauses=m, n_features=f)
    tcfg = ttm.TMConfig(n_classes=c, n_clauses=m, n_features=f)
    assert tcfg.n_literals == jcfg.n_literals
    jst = jtm.TMState(ta=jnp.asarray(ta))
    tst = state_from_numpy(ta, device="cpu")
    np.testing.assert_array_equal(ttm.include_mask(tcfg, tst).numpy(),
                                  np.asarray(jtm.include_mask(jcfg, jst)))
    for empty in (1, 0):
        ref = jtm.clause_outputs(jcfg, jst, jnp.asarray(lits),
                                 empty_clause_output=empty)
        got = ttm.clause_outputs(tcfg, tst, torch.from_numpy(lits),
                                 empty_clause_output=empty)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        ttm.class_sums(tcfg, got).numpy(),
        np.asarray(jtm.class_sums(jcfg, ref)))
    np.testing.assert_array_equal(
        ttm.predict(tcfg, tst, torch.from_numpy(lits)).numpy(),
        np.asarray(jtm.predict(jcfg, jst, jnp.asarray(lits))))


def test_init_tm_boundary_and_seeded():
    """init_tm draws from a torch.Generator (not held to jax.random): TAs
    sit on the include/exclude boundary {N, N+1}, reproducibly."""
    cfg = ttm.TMConfig(n_classes=3, n_clauses=10, n_features=12)
    a = ttm.init_tm(cfg, torch.Generator().manual_seed(4)).ta
    b = ttm.init_tm(cfg, torch.Generator().manual_seed(4)).ta
    assert a.shape == (3, 10, 24) and a.dtype == torch.int32
    assert set(a.unique().tolist()) == {cfg.n_states, cfg.n_states + 1}
    assert torch.equal(a, b)


def test_state_from_numpy_validates():
    with pytest.raises(ValueError, match="integer array"):
        state_from_numpy(np.zeros((2, 3)), device="cpu")
    with pytest.raises(ValueError, match="integer array"):
        state_from_numpy(np.zeros((2, 3), np.int32), device="cpu")
    st = state_from_numpy(np.full((1, 2, 4), 129, np.int64), device="cpu")
    assert st.ta.dtype == torch.int32 and st.ta.device.type == "cpu"
