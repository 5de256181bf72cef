"""Port parity: the reference trainer (``repro_torch.core.tm_train``), the
plain version of kernel K2 (``repro_torch.kernels.train_fused``) and the
train engines (``repro_torch.engine.train``) against the JAX package, bit
for bit, for threefry keys.

Inputs are rebuilt from numpy seeds the way ``tests/test_train_engine.py``
builds them (``_random_tm``); a JAX key crosses over as its raw key data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tm import TMConfig as JConfig
from repro.core.tm import TMState as JState
from repro.core import tm_train as jtrain
from repro.engine import export_key_cursor as jexport_key_cursor
from repro.engine import get_train_engine as jget_train_engine
from repro.kernels import train_fused as jfused
from repro_torch.core import prng
from repro_torch.core import tm_train as ttrain
from repro_torch.core.tm import TMConfig, TMState
from repro_torch.engine import (DEFAULT_TRAIN_BACKEND,
                                available_train_backends,
                                clear_train_engine_cache, export_key_cursor,
                                get_train_engine, import_key_cursor,
                                train_engine_cache_info, train_engine_opts)
from repro_torch.kernels import train_fused as tfused
from repro_torch.kernels.ops import launches

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

PORTED = ["fused", "packed", "reference", "sparse"]
# (C, M, F): odd M (unequal polarity halves), C=2 (forced negative class)
SHAPES = [(2, 6, 9), (3, 10, 12), (5, 7, 33), (4, 12, 5), (10, 25, 49)]


def _random_tm(c, m, f, *, density=0.15, seed=0, batch=17, s=3.9):
    """numpy inputs built like tests/test_train_engine.py::_random_tm."""
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random((c, m, 2 * f)) < density, 129, 128) \
        .astype(np.int32)
    lits = rng.integers(0, 2, (batch, 2 * f), dtype=np.int8)
    lits[0] = 0
    lits[-1] = 1
    y = rng.integers(0, c, (batch,), dtype=np.int32)
    k = min(c, batch)
    y[:k] = np.arange(k)
    return (JConfig(c, m, f, T=5, s=s), TMConfig(c, m, f, T=5, s=s),
            ta, lits, y)


def _keys(seed):
    key = jax.random.key(seed)
    return key, prng.wrap_key_data(np.asarray(jax.random.key_data(key)))


def _jax_step(jcfg, ta, key, lits, y, **kw):
    return np.asarray(jtrain.train_step(jcfg, JState(jnp.asarray(ta)), key,
                                        jnp.asarray(lits), jnp.asarray(y),
                                        **kw).ta)


# -- reference trainer ------------------------------------------------------

def test_feedback_thresholds_probabilities_exact():
    """(T − v)/2T and (T + v)/2T in float32 for every clipped vote, and
    the u < p decisions on uniforms placed right at each p."""
    for t in (1, 5, 15, 16):
        jcfg, tcfg = JConfig(3, 4, 2, T=t), TMConfig(3, 4, 2, T=t)
        v = np.arange(-t - 2, t + 3, dtype=np.int32)
        b = v.shape[0]
        votes = np.tile(v[:, None], (1, 3))
        y = np.zeros(b, np.int32)
        offs = np.ones(b, np.int32)
        p = np.clip(t - v, 0, 2 * t).astype(np.float32) / np.float32(2 * t)
        # uniforms at p, one ulp below and above it: the decision boundary
        u = np.stack([np.nextafter(p, 0), p, np.nextafter(p, 1), p],
                     1).astype(np.float32)
        u = np.stack([u, u[:, ::-1]], 1)                       # (B, 2, 4)
        want = jtrain.feedback_thresholds(jcfg, jnp.asarray(votes),
                                          jnp.asarray(y), jnp.asarray(offs),
                                          jnp.asarray(u))
        got = ttrain.feedback_thresholds(
            tcfg, torch.from_numpy(votes), torch.from_numpy(y),
            torch.from_numpy(offs), torch.from_numpy(u))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("boost", [True, False], ids=["boost", "no_boost"])
@pytest.mark.parametrize("density", [0.0, 0.15, 1.0])
def test_feedback_masks_and_update_match_jax(boost, density):
    jcfg, tcfg, ta, lits, y = _random_tm(4, 9, 13, density=density, seed=5)
    key, tkey = _keys(3)
    jst = JState(jnp.asarray(ta))
    from repro.core.tm import class_sums, clause_outputs
    clauses = clause_outputs(jcfg, jst, jnp.asarray(lits))
    votes = class_sums(jcfg, clauses)
    want = jtrain.feedback_masks(jcfg, key, votes, jnp.asarray(y))
    got = ttrain.feedback_masks(tcfg, tkey,
                                torch.from_numpy(np.array(votes)),
                                torch.from_numpy(y).to(torch.int64))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(prng.key_data(g),
                                      np.asarray(jax.random.key_data(w)))
    new = jtrain.feedback_update(jcfg, jst, key, jnp.asarray(lits),
                                 jnp.asarray(y), clauses, votes,
                                 boost_tpf=boost)
    tnew = ttrain.feedback_update(
        tcfg, TMState(torch.from_numpy(ta)), tkey, torch.from_numpy(lits),
        torch.from_numpy(y).to(torch.int64),
        torch.from_numpy(np.array(clauses)),
        torch.from_numpy(np.array(votes)), boost_tpf=boost)
    np.testing.assert_array_equal(tnew.ta.numpy(), np.asarray(new.ta))


@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: "C{}M{}F{}".format(*s))
def test_train_step_matches_jax(shape):
    jcfg, tcfg, ta, lits, y = _random_tm(*shape, seed=sum(shape))
    key, tkey = _keys(sum(shape) + 1)
    got = ttrain.train_step(tcfg, TMState(torch.from_numpy(ta)), tkey,
                            lits, y)
    np.testing.assert_array_equal(got.ta.numpy(),
                                  _jax_step(jcfg, ta, key, lits, y))


@pytest.mark.parametrize("boost", [True, False], ids=["boost", "no_boost"])
def test_twenty_step_chain_matches_jax(boost):
    """20 steps on one key chain: any drift compounds, so a chain pins the
    contract harder than one step."""
    jcfg, tcfg, ta, lits, y = _random_tm(3, 10, 12, seed=9, batch=24)
    key, tkey = _keys(4)
    jst = JState(jnp.asarray(ta))
    tst = TMState(torch.from_numpy(ta))
    rng = np.random.default_rng(10)
    for _ in range(20):
        rows = rng.integers(0, 24, 8)
        key, k = jax.random.split(key)
        tkey, tk = prng.split(tkey)
        jst = jtrain.train_step(jcfg, jst, k, jnp.asarray(lits[rows]),
                                jnp.asarray(y[rows]), boost_tpf=boost)
        tst = ttrain.train_step(tcfg, tst, tk, lits[rows], y[rows],
                                boost_tpf=boost)
    np.testing.assert_array_equal(tst.ta.numpy(), np.asarray(jst.ta))
    assert (tst.ta.numpy() != ta).any()


@pytest.mark.parametrize("backend", [None] + PORTED)
def test_train_epoch_matches_jax(backend):
    jcfg, tcfg, ta, lits, y = _random_tm(3, 10, 12, seed=23, batch=40)
    key, tkey = _keys(5)
    want = jtrain.train_epoch(jcfg, JState(jnp.asarray(ta)), key,
                              jnp.asarray(lits), jnp.asarray(y),
                              batch_size=8)
    got = ttrain.train_epoch(tcfg, TMState(torch.from_numpy(ta)), tkey,
                             lits, y, batch_size=8, backend=backend)
    np.testing.assert_array_equal(got.ta.numpy(), np.asarray(want.ta))


def test_evaluate_matches_jax():
    """Accuracy is a float32 mean: XLA divides by the count through its
    reciprocal, so the two agree to one float32 rounding (rel 1e-6)."""
    jcfg, tcfg, ta, lits, y = _random_tm(3, 10, 12, seed=2, batch=40)
    want = jtrain.evaluate(jcfg, JState(jnp.asarray(ta)), jnp.asarray(lits),
                           jnp.asarray(y))
    assert 0 < want < 1
    assert ttrain.evaluate(tcfg, TMState(torch.from_numpy(ta)), lits,
                           y) == pytest.approx(want, rel=1e-6)


# -- K2's plain version -----------------------------------------------------

def _delta_inputs(b, m, L, c, seed, *, masks_on=True):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, (b, L), dtype=np.int8)
    bits1 = rng.integers(0, 2**32, (b, m, L), dtype=np.uint32)
    bits2 = rng.integers(0, 2**32, (b, m, L), dtype=np.uint32)
    inc_t = rng.integers(0, 2, (b, m, L), dtype=np.int8)
    inc_n = rng.integers(0, 2, (b, m, L), dtype=np.int8)
    masks = [rng.integers(0, 2, (b, m)).astype(bool) & masks_on
             for _ in range(4)]
    y = rng.integers(0, c, (b,), dtype=np.int32)
    yn = ((y + rng.integers(1, c, (b,))) % c).astype(np.int32)
    return x, bits1, bits2, inc_t, inc_n, masks, y, yn


def _port_deltas(x, bits1, bits2, inc_t, inc_n, masks, y, yn, **kw):
    t = torch.from_numpy
    return tfused.train_deltas(
        t(x), t(bits1.view(np.int32)), t(bits2.view(np.int32)), t(inc_t),
        t(inc_n), *[t(mm) for mm in masks], t(y), t(yn), **kw).numpy()


@pytest.mark.parametrize("case", [(21, 11, 37, 5, True), (8, 4, 64, 2, True),
                                  (33, 7, 18, 6, True), (9, 5, 12, 3, False)],
                         ids=lambda c: "B{}M{}L{}C{}{}".format(
                             *c[:4], "" if c[4] else "-masks_off"))
def test_train_deltas_matches_jax(case):
    b, m, L, c, on = case
    args = _delta_inputs(b, m, L, c, seed=b + m, masks_on=on)
    x, bits1, bits2, inc_t, inc_n, masks, y, yn = args
    kw = dict(n_classes=c, p_inc=2.9 / 3.9, p_dec=1 / 3.9)
    want = jfused.train_deltas(jnp.asarray(x), jnp.asarray(bits1),
                               jnp.asarray(bits2), jnp.asarray(inc_t),
                               jnp.asarray(inc_n),
                               *[jnp.asarray(mm) for mm in masks],
                               jnp.asarray(y), jnp.asarray(yn), **kw)
    got = _port_deltas(*args, **kw)
    assert got.dtype == np.int32 and got.shape == (c, m, L)
    np.testing.assert_array_equal(got, np.asarray(want))
    if not on:
        assert not got.any()


def test_train_deltas_matches_pallas_interpret():
    """The Pallas kernel itself, in interpret mode (as
    tests/test_train_engine.py runs it), at one small shape."""
    b, m, L, c = 21, 11, 37, 5
    args = _delta_inputs(b, m, L, c, seed=13)
    x, bits1, bits2, inc_t, inc_n, masks, y, yn = args
    kw = dict(n_classes=c, p_inc=1.0, p_dec=1 / 3.9)
    want = jfused.train_deltas_pallas(
        jnp.asarray(x), jnp.asarray(bits1), jnp.asarray(bits2),
        jnp.asarray(inc_t), jnp.asarray(inc_n),
        *[jnp.asarray(mm) for mm in masks], jnp.asarray(y),
        jnp.asarray(yn), block_b=8, block_m=4, interpret=True, **kw)
    np.testing.assert_array_equal(_port_deltas(*args, **kw),
                                  np.asarray(want))


@pytest.mark.parametrize("masks_on", [True, False], ids=["masks", "off"])
def test_train_deltas_keyed_equals_train_deltas(masks_on):
    """K2's contract: keys + the whole include mask in, the same sum as
    train_deltas on the words the keys draw and the gathered rows.  Class
    1 is the target of row 0 and the negative class of row 1."""
    b, m, L, c = 12, 6, 20, 4
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 2, (b, L), dtype=np.int8))
    include = torch.from_numpy(rng.integers(0, 2, (c, m, L), dtype=np.int8))
    keys = prng.bits(prng.key(9), (2, b, 2))
    masks = [torch.from_numpy(rng.integers(0, 2, (b, m)).astype(bool))
             & masks_on for _ in range(4)]
    y = torch.from_numpy(rng.integers(0, c, (b,)).astype(np.int32))
    yn = (y + torch.from_numpy(rng.integers(1, c, (b,)))) % c
    y[0], yn[0], y[1], yn[1] = 1, 2, 3, 1
    kw = dict(n_classes=c, p_inc=6 / 7, p_dec=1 / 7)
    n = launches("train_deltas")
    got = tfused.train_deltas_keyed(x, keys[0], keys[1], include, *masks, y,
                                    yn, **kw)
    assert launches("train_deltas") == n   # CPU: plain version
    want = tfused.train_deltas(x, prng.bits(keys[0], (m, L)),
                               prng.bits(keys[1], (m, L)), include[y],
                               include[yn], *masks, y, yn, **kw)
    assert torch.equal(got, want)
    assert got.any() == masks_on


# (B, C, M, L, density, masks): the edges of kernel K2's batch split and
# class tiles, as tests/test_torch_cuda.py::K2_CASES holds the kernel to
# this plain version there — B = 2, 31, 33, 128, 129, 257, 512 around its 4
# batch groups and 128-row chunks; C = 13, 24, 25 and 49 around and
# across its 24-class tile at L = 1568; every mask on; L = 2049 / 4096
K2_EDGES = [(2, 10, 50, 1568, 0.05, "masks"),
            (31, 10, 50, 1568, 0.05, "masks"),
            (33, 10, 50, 1568, 0.05, "masks"),
            (128, 10, 4, 1568, 0.05, "masks"),
            (129, 10, 4, 1568, 0.05, "masks"),
            (257, 10, 4, 1568, 0.05, "masks"),
            (512, 10, 4, 1568, 0.05, "masks"),
            (40, 13, 5, 1568, 0.2, "masks"), (33, 25, 3, 1568, 0.1, "masks"),
            (30, 24, 3, 1568, 0.1, "masks"), (33, 49, 2, 1568, 0.1, "masks"),
            (32, 10, 50, 1568, 0.05, "all"), (37, 4, 6, 130, 0.3, "all"),
            (20, 4, 3, 2049, 0.01, "masks"), (20, 3, 3, 4096, 0.01, "all")]


@pytest.mark.parametrize("case", K2_EDGES,
                         ids=lambda c: "B{}C{}M{}L{}-d{}-{}".format(*c))
def test_train_deltas_keyed_matches_jax_at_kernel_edges(case):
    """K2's plain version (CPU: ``train_deltas_keyed``) against the JAX
    package's ``train_deltas`` on the words the row keys draw and the
    gathered include rows."""
    b, c, m, L, density, masks = case
    rng = np.random.default_rng(b + c + m + L)
    x = rng.integers(0, 2, (b, L), dtype=np.int8)
    include = (rng.random((c, m, L)) < density).astype(np.int8)
    mk = [(rng.random((b, m)) < 0.5) | (masks == "all") for _ in range(4)]
    y = rng.integers(0, c, (b,), dtype=np.int32)
    yn = ((y + rng.integers(1, c, (b,))) % c).astype(np.int32)
    keys = prng.bits(prng.key(b + L), (2, b, 2))
    kw = dict(n_classes=c, p_inc=6 / 7, p_dec=1 / 7)
    t = torch.from_numpy
    got = tfused.train_deltas_keyed(t(x), keys[0], keys[1], t(include),
                                    *[t(a) for a in mk], t(y), t(yn), **kw)
    bits = [prng.bits(k, (m, L)).numpy().view(np.uint32) for k in keys]
    want = jfused.train_deltas(jnp.asarray(x), jnp.asarray(bits[0]),
                               jnp.asarray(bits[1]),
                               jnp.asarray(include[y]),
                               jnp.asarray(include[yn]),
                               *[jnp.asarray(a) for a in mk],
                               jnp.asarray(y), jnp.asarray(yn), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()


def test_train_deltas_keyed_rejects_bad_inputs():
    b, m, L, c = 4, 3, 8, 2
    x = torch.zeros((b, L), dtype=torch.int8)
    keys = torch.zeros((b, 2), dtype=torch.int32)
    inc = torch.zeros((c, m, L), dtype=torch.int8)
    masks = [torch.zeros((b, m), dtype=torch.bool)] * 4
    y = torch.zeros(b, dtype=torch.int32)
    kw = dict(n_classes=c, p_inc=1.0, p_dec=0.5)
    with pytest.raises(ValueError, match="keys1"):
        tfused.train_deltas_keyed(x, keys.to(torch.int64), keys, inc,
                                  *masks, y, y, **kw)
    with pytest.raises(ValueError, match="include"):
        tfused.train_deltas_keyed(x, keys, keys, inc[:, :, :-1], *masks, y,
                                  y, **kw)
    with pytest.raises(ValueError, match="n_classes"):
        tfused.train_deltas_keyed(x, keys, keys, inc, *masks, y, y,
                                  n_classes=3, p_inc=1.0, p_dec=0.5)


def test_uniform_threshold_matches_jax():
    ps = [1.0, 0.5, 1 / 3.9, 2.9 / 3.9, 1 / 7, 6 / 7, 1e-4, 0.999999, 0.0,
          *np.random.default_rng(0).random(64).tolist()]
    for p in ps:
        assert tfused.uniform_threshold(p) == jfused.uniform_threshold(p), p


def test_feedback_polarity_masks_match_jax():
    rng = np.random.default_rng(1)
    fb_t, fb_n = (rng.integers(0, 2, (5, 7)).astype(bool) for _ in range(2))
    pos = (np.arange(7) % 2 == 0)[None, :]
    want = jfused.feedback_polarity_masks(jnp.asarray(fb_t),
                                          jnp.asarray(fb_n),
                                          jnp.asarray(pos))
    got = tfused.feedback_polarity_masks(torch.from_numpy(fb_t),
                                         torch.from_numpy(fb_n),
                                         torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- engines ----------------------------------------------------------------

def test_registry():
    assert set(PORTED) <= set(available_train_backends())
    assert DEFAULT_TRAIN_BACKEND in available_train_backends()
    with pytest.raises(KeyError, match="unknown TrainEngine backend"):
        get_train_engine("shardd", TMConfig(2, 4, 3))
    # "sharded" is registered; its default mesh is every visible GPU
    # (tests/test_torch_multihost.py holds it on simulated CPU meshes)
    assert "sharded" in available_train_backends()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            get_train_engine("sharded", TMConfig(2, 4, 3))


@pytest.mark.parametrize("shape", SHAPES[::2],
                         ids=lambda s: "C{}M{}F{}".format(*s))
@pytest.mark.parametrize("backend", PORTED)
def test_engine_matches_jax(backend, shape):
    """Each port engine equals JAX train_step and JAX's engine of the same
    name, on CPU tensors (C=2, odd M and the widest shape; train_step
    itself runs every shape above)."""
    jcfg, tcfg, ta, lits, y = _random_tm(*shape, seed=sum(shape))
    key, tkey = _keys(sum(shape) + 1)
    want = _jax_step(jcfg, ta, key, lits, y)
    np.testing.assert_array_equal(
        np.asarray(jget_train_engine(backend, jcfg).step(
            JState(jnp.asarray(ta)), key, jnp.asarray(lits),
            jnp.asarray(y)).ta), want)
    got = get_train_engine(backend, tcfg).step(TMState(torch.from_numpy(ta)),
                                               tkey, lits, y)
    assert got.ta.dtype == torch.int32
    np.testing.assert_array_equal(got.ta.numpy(), want)


@pytest.mark.parametrize("density", [0.0, 1.0],
                         ids=["all_exclude", "all_include"])
@pytest.mark.parametrize("backend", PORTED)
def test_engine_density_extremes_and_no_boost(backend, density):
    jcfg, tcfg, ta, lits, y = _random_tm(3, 8, 11, density=density, seed=21)
    key, tkey = _keys(2)
    for boost in (True, False):
        got = get_train_engine(backend, tcfg, boost_tpf=boost).step(
            TMState(torch.from_numpy(ta)), tkey, lits, y)
        np.testing.assert_array_equal(
            got.ta.numpy(), _jax_step(jcfg, ta, key, lits, y,
                                      boost_tpf=boost))


def test_engines_at_tm_mnist_width():
    """tm-mnist-50 (C=10, M=50, F=784, T=5, s=7) at a 32-row labeled
    batch: every port engine agrees with JAX train_step."""
    jcfg, tcfg, ta, lits, y = _random_tm(10, 50, 784, density=0.05, seed=4,
                                         batch=32, s=7.0)
    key, tkey = _keys(6)
    want = _jax_step(jcfg, ta, key, lits, y)
    for backend in PORTED:
        got = get_train_engine(backend, tcfg).step(
            TMState(torch.from_numpy(ta)), tkey, lits, y)
        np.testing.assert_array_equal(got.ta.numpy(), want,
                                      err_msg=backend)


@pytest.mark.parametrize("backend", PORTED)
def test_engine_rejects_out_of_range_labels(backend):
    _, tcfg, ta, lits, y = _random_tm(3, 4, 5, seed=1, batch=4)
    eng = get_train_engine(backend, tcfg)
    for bad in (y + 3, y - 4):
        with pytest.raises(ValueError, match="out of range"):
            eng.step(TMState(torch.from_numpy(ta)), prng.key(0), lits, bad)


def test_train_engine_cache():
    clear_train_engine_cache()
    cfg = TMConfig(3, 8, 10)
    e1 = get_train_engine("packed", cfg)
    assert get_train_engine("packed", cfg) is e1
    assert train_engine_cache_info()["hits"] >= 1
    assert get_train_engine("packed", cfg, boost_tpf=False) is not e1
    assert get_train_engine("packed", cfg, cache=False) is not e1
    assert get_train_engine("packed", TMConfig(3, 8, 10)) is e1


def test_engine_opts_match_jax():
    jcfg, tcfg = JConfig(3, 8, 10), TMConfig(3, 8, 10)
    from repro.engine import train_engine_opts as jtrain_engine_opts
    for backend in PORTED:
        want = jtrain_engine_opts(jget_train_engine(backend, jcfg,
                                                    cache=False))
        got = train_engine_opts(get_train_engine(backend, tcfg, cache=False))
        if backend in ("fused", "sparse"):
            want = {**want, "block_b": 64, "block_m": 128}
        assert got == want, backend
    assert train_engine_opts(object()) == {}


def test_key_cursor_round_trip_and_exchange():
    """A cursor is raw uint32 data + the impl name, exchangeable with the
    JAX package's in both directions; rbg cursors raise."""
    key = jax.random.split(jax.random.key(2**31 + 9))[0]
    jdata, jimpl = jexport_key_cursor(key)
    tkey = import_key_cursor(jdata, jimpl)
    data, impl = export_key_cursor(tkey)
    assert impl == jimpl == "threefry2x32" and data.dtype == np.uint32
    np.testing.assert_array_equal(data, jdata)
    from repro.engine import import_key_cursor as jimport_key_cursor
    back = jimport_key_cursor(data, impl)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(back, (4,), jnp.uint32)),
        prng.key_data(prng.bits(tkey, (4,))))
    rdata, rimpl = jexport_key_cursor(jax.random.key(1, impl="rbg"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        import_key_cursor(rdata, rimpl)
