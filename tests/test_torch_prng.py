"""Port parity: ``repro_torch.core.prng`` against ``jax.random`` with the
default threefry2x32 implementation, bit for bit — keys, splits, raw
words, float32 uniforms, randint and the per-row draws of the training
step's PRNG contract (``repro.core.tm_train.feedback_draws``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tm import TMConfig as JConfig
from repro.core.tm_train import feedback_draws as jfeedback_draws
from repro_torch.core import prng
from repro_torch.core.tm import TMConfig
from repro_torch.core.tm_train import feedback_draws

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)


def _data(key):
    return np.asarray(jax.random.key_data(key))


def _port_key(key):
    return prng.wrap_key_data(_data(key))


@pytest.mark.parametrize("seed", [0, 11, 2**32 + 5, 2**31 + 3, -1])
def test_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.key_data(prng.key(seed)),
                                  _data(jax.random.key(seed)))


@pytest.mark.parametrize("num", [1, 2, 3, 17])
def test_split_matches_jax(num):
    key = jax.random.key(7)
    got = prng.split(prng.key(7), num)
    assert got.shape == (num, 2) and got.dtype == torch.int32
    np.testing.assert_array_equal(prng.key_data(got),
                                  _data(jax.random.split(key, num)))
    # a split of a split: the chain the server walks
    chain = jax.random.split(key)[0]
    np.testing.assert_array_equal(
        prng.key_data(prng.split(prng.split(prng.key(7))[0], num)),
        _data(jax.random.split(chain, num)))


@pytest.mark.parametrize("shape", [(5, 7), (1,), (3, 2, 9), (0, 4)])
def test_bits_matches_jax(shape):
    key = jax.random.key(7)
    got = prng.bits(_port_key(key), shape)
    assert got.shape == shape and got.dtype == torch.int32
    np.testing.assert_array_equal(
        prng.key_data(got), np.asarray(jax.random.bits(key, shape,
                                                       jnp.uint32)))


def test_uniform_matches_jax_bitwise():
    for seed in (7, 99):
        key = jax.random.key(seed)
        got = prng.uniform(_port_key(key), (4, 2, 9))
        assert got.dtype == torch.float32
        want = np.asarray(jax.random.uniform(key, (4, 2, 9)))
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("bounds", [(1, 2), (1, 3), (1, 10), (1, 128),
                                    (0, 1), (5, 5), (-5, 7),
                                    (0, 2**31 - 1)],
                         ids=lambda b: f"{b[0]}..{b[1]}")
def test_randint_matches_jax(bounds):
    """Spans 1, 2, 9 and 127 among them; the large span wraps the
    multiplier in uint32 arithmetic, as JAX does."""
    lo, hi = bounds
    for seed in (7, 8):
        key = jax.random.key(seed)
        got = prng.randint(_port_key(key), (33,), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.randint(key, (33,), lo, hi)))


def test_batched_keys_draw_like_vmap():
    """A (B, 2) key batch draws row by row, as vmap over wrapped keys."""
    w = jax.random.bits(jax.random.key(3), (6, 2), jnp.uint32)
    keys = jax.random.wrap_key_data(w, impl="threefry2x32")
    tk = prng.wrap_key_data(np.asarray(w))
    np.testing.assert_array_equal(
        prng.key_data(prng.bits(tk, (3, 5))),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, (3, 5),
                                                      jnp.uint32))(keys)))
    np.testing.assert_array_equal(
        prng.uniform(tk, (3, 5)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3, 5)))(keys)))


def test_wrap_key_data_round_trip_and_errors():
    data = np.array([[0, 4294967295], [2**31, 12]], np.uint32)
    keys = prng.wrap_key_data(data)
    assert keys.dtype == torch.int32 and keys.shape == (2, 2)
    np.testing.assert_array_equal(prng.key_data(keys), data)
    np.testing.assert_array_equal(
        prng.key_data(prng.wrap_key_data(keys)), data)
    with pytest.raises(ValueError, match="trailing axis"):
        prng.wrap_key_data(np.zeros((3,), np.uint32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        prng.wrap_key_data(np.zeros((4,), np.uint32), impl="rbg")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        prng.key(0, impl="rbg")


@pytest.mark.parametrize("shape", [(2, 6, 9, 17), (5, 7, 33, 4),
                                   (10, 50, 784, 32)],
                         ids=lambda s: "C{}M{}F{}B{}".format(*s))
def test_feedback_draws_match_jax(shape):
    """The votes-independent half of the training PRNG contract: the
    negative-class offsets, the feedback uniforms and the per-row keys,
    and each row's Type I words drawn from its key."""
    c, m, f, b = shape
    key = jax.random.key(c + m + b)
    offs, u, k1s, k2s = jfeedback_draws(JConfig(c, m, f), key, b)
    got = feedback_draws(TMConfig(c, m, f), _port_key(key), b)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(offs))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(u))
    np.testing.assert_array_equal(prng.key_data(got[2]), _data(k1s))
    np.testing.assert_array_equal(prng.key_data(got[3]), _data(k2s))
    rows = slice(0, 3)
    want = jax.vmap(lambda k: jax.random.bits(k, (m, 2 * f),
                                              jnp.uint32))(k2s[rows])
    np.testing.assert_array_equal(
        prng.key_data(prng.bits(got[3][rows], (m, 2 * f))),
        np.asarray(want))
