"""Port parity for the BNN surface (``core/bnn``), the booleanizers and
the synthetic datasets, against the JAX package on the same inputs; and
the ``launch/bnn_popcount`` entry point on the CPU.

Tolerances, with their reasons:

- ``bnn_apply``: bitwise — ±1 products summed to integers below 2²⁴ are
  exact in any order.
- ``bnn_loss`` and one gradient step: rtol 1e-6 (atol 1e-7 on the step
  where ``w − lr·g`` cancels): ``log_softmax`` and the gradient's
  float32 sums run in another order than XLA's.
- ``time_domain_sign`` / ``bnn_predict_time_domain`` on one device with
  ``sigma_noise=0``: bitwise on an integer-valued device (every delay
  sum exact); on a ``make_device`` float device, exact away from
  neurons whose match count is within one of the neutral line's (there
  the race is decided by float rounding).
- ``mnist_like``, ``iris_like``, ``to_literals`` and the booleanizers:
  bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bnn as jbnn
from repro.core import time_domain as jtd
from repro.core.booleanize import QuantileBooleanizer as JQuantile
from repro.core.booleanize import threshold_booleanize as jthreshold
from repro.core.booleanize import to_literals as jto_literals
from repro.data import iris_like as jiris_like
from repro.data import mnist_like as jmnist_like
from repro_torch.convert import bnn_params_from_numpy, device_from_numpy
from repro_torch.core import bnn
from repro_torch.core import time_domain as td
from repro_torch.core.booleanize import (QuantileBooleanizer,
                                         threshold_booleanize, to_literals)
from repro_torch.data import iris_like, mnist_like

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)


def _toy_data(n=96, d=32, classes=4, seed=0):
    """±1 rows around class prototypes, as tests/test_bnn.py builds them."""
    rng = np.random.default_rng(seed)
    protos = rng.choice([-1.0, 1.0], (classes, d))
    y = rng.integers(0, classes, n)
    flip = rng.random((n, d)) < 0.08
    x = protos[y] * np.where(flip, -1.0, 1.0)
    return x.astype(np.float32), y.astype(np.int32)


def _both_params(cfg_kw, seed=0):
    jcfg = jbnn.BNNConfig(**cfg_kw)
    jp = jbnn.init_bnn(jcfg, jax.random.key(seed))
    tp = bnn_params_from_numpy([np.asarray(w) for w in jp.weights],
                               device="cpu")
    return jcfg, jp, bnn.BNNConfig(**cfg_kw), tp


CFG = dict(in_features=32, hidden=(24, 16), n_classes=4)


def test_binarize_ste_grad():
    w = torch.tensor([0.5, -2.0, 1.0, -0.0], requires_grad=True)
    out = bnn.binarize_ste(w)
    out.sum().backward()
    assert out.tolist() == [1.0, -1.0, 1.0, 1.0]
    assert w.grad.tolist() == [1.0, 0.0, 1.0, 1.0]   # clipped identity
    jg = jax.grad(lambda v: jbnn.binarize_ste(v).sum())(
        jnp.asarray([0.5, -2.0, 1.0, -0.0]))
    assert jg.tolist() == w.grad.tolist()


@pytest.mark.parametrize("hard", [True, False])
def test_bnn_apply_matches_jax(hard):
    x, _ = _toy_data()
    jcfg, jp, cfg, tp = _both_params(CFG)
    want = np.asarray(jbnn.bnn_apply(jcfg, jp, jnp.asarray(x), hard=hard))
    got = bnn.bnn_apply(cfg, tp, torch.from_numpy(x), hard=hard).numpy()
    if hard:
        np.testing.assert_array_equal(got, want)
    else:   # tanh hidden activations: float, not integer sums
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bnn_loss_and_one_step_match_jax():
    x, y = _toy_data()
    jcfg, jp, cfg, tp = _both_params(CFG, seed=1)
    lr = 0.05
    jl, jg = jax.value_and_grad(
        lambda q: jbnn.bnn_loss(jcfg, q, jnp.asarray(x), jnp.asarray(y)))(jp)
    ws = [w.clone().requires_grad_() for w in tp.weights]
    loss = bnn.bnn_loss(cfg, bnn.BNNParams(tuple(ws)), torch.from_numpy(x),
                        torch.from_numpy(y))
    grads = torch.autograd.grad(loss, ws)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    for w, g, jw, jgw in zip(ws, grads, jp.weights, jg.weights):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgw), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose((w - lr * g).detach().numpy(),
                                   np.asarray(jw - lr * jgw), rtol=1e-6,
                                   atol=1e-7)


def _match_bits(seed, b=8, nn_=6, n=64):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (b, nn_, n), dtype=np.int8)


def test_time_domain_sign_bitwise_on_integer_device():
    """Integer-valued element offsets: every delay sum is exact, so the
    sign of each neuron's race is the same bit in both packages."""
    b, nn_, n = 8, 6, 64
    match = _match_bits(1, b, nn_, n)
    rng = np.random.default_rng(2)
    off = rng.integers(-3, 4, (nn_ + 1, n, 2)).astype(np.float32)
    skew = np.zeros((nn_ + 1,), np.float32)
    kw = dict(d_low=384.0, d_high=618.0, sigma_noise=0.0)
    want = np.asarray(jbnn.time_domain_sign(
        jtd.PDLConfig(**kw), jtd.PDLDevice(jnp.asarray(off), jnp.asarray(skew)),
        jnp.asarray(match)))
    got = bnn.time_domain_sign(td.PDLConfig(**kw),
                               device_from_numpy(off, skew, device="cpu"),
                               torch.from_numpy(match))
    np.testing.assert_array_equal(got.numpy(), want)


def test_time_domain_sign_on_carried_float_device():
    b, nn_, n = 8, 6, 64
    match = _match_bits(3, b, nn_, n)
    jpdl = jtd.PDLConfig(sigma_elem=0.5, sigma_noise=0.0)
    jdev = jtd.make_device(jpdl, nn_ + 1, n, jax.random.key(2))
    want = np.asarray(jbnn.time_domain_sign(jpdl, jdev, jnp.asarray(match)))
    got = bnn.time_domain_sign(
        td.PDLConfig(sigma_elem=0.5, sigma_noise=0.0),
        device_from_numpy(np.asarray(jdev.elem_offset),
                          np.asarray(jdev.skew), device="cpu"),
        torch.from_numpy(match)).numpy()
    counts = match.sum(-1)
    clear = np.abs(counts - n // 2) > 1
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], want[clear])
    # and it is the paper's threshold away from the tie
    np.testing.assert_array_equal(got[clear],
                                  np.where(counts > n // 2, 1.0, -1.0)[clear])


def test_bnn_predict_time_domain_matches_jax():
    x, _ = _toy_data(n=40)
    cfg_kw = dict(in_features=32, hidden=(16,), n_classes=4)
    jcfg, jp, cfg, tp = _both_params(cfg_kw, seed=2)
    rng = np.random.default_rng(5)
    off = rng.integers(-3, 4, (17, 32, 2)).astype(np.float32)
    skew = np.zeros((17,), np.float32)
    kw = dict(d_low=384.0, d_high=618.0, sigma_noise=0.0)
    want = np.asarray(jbnn.bnn_predict_time_domain(
        jcfg, jp, jtd.PDLConfig(**kw),
        [jtd.PDLDevice(jnp.asarray(off), jnp.asarray(skew))], jnp.asarray(x)))
    got = bnn.bnn_predict_time_domain(
        cfg, tp, td.PDLConfig(**kw),
        [device_from_numpy(off, skew, device="cpu")], torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_datasets_match_jax():
    for n, seed in ((3, 0), (5, 7)):
        for a, b in zip(mnist_like(n_per_class=n, seed=seed),
                        jmnist_like(n_per_class=n, seed=seed)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for a, b in zip(iris_like(n, seed), jiris_like(n, seed)):
            np.testing.assert_array_equal(a, b)


def test_booleanizers_and_literals_match_jax():
    x, _ = mnist_like(n_per_class=2, seed=1)
    xb = threshold_booleanize(x, 75.0)
    np.testing.assert_array_equal(xb, jthreshold(x, 75.0))
    np.testing.assert_array_equal(threshold_booleanize(torch.from_numpy(x)),
                                  xb)
    lits = to_literals(xb)
    assert lits.dtype == torch.int8 and lits.shape == (20, 2 * 784)
    np.testing.assert_array_equal(lits.numpy(),
                                  np.asarray(jto_literals(jnp.asarray(xb))))
    xi, _ = iris_like(20, 3)
    q, jq = QuantileBooleanizer(3).fit(xi), JQuantile(3).fit(xi)
    np.testing.assert_array_equal(q.transform(xi), jq.transform(xi))
    assert q.n_boolean_features == jq.n_boolean_features == 12
    with pytest.raises(RuntimeError, match="fit"):
        QuantileBooleanizer(3).transform(xi)


def test_bnn_launcher_on_cpu(capsys):
    """The port's bnn_popcount entry point end to end on the CPU: trains,
    checks the ±1 GEMM against the int32 matmul, races the hidden layer."""
    from repro_torch.launch.bnn_popcount import main
    out = main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "matches the int32 matmul: OK (120, 128)" in text
    assert out["h_shape"] == (120, 128)
    assert out["losses"][-1] < out["losses"][0]
    assert 0.0 <= out["agreement"] <= 1.0
