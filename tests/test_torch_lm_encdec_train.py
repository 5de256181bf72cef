"""Port parity for training the encdec family (seamless-m4t-large-v2: the
bidirectional encoder over ``frames``, the decoder's self- and
cross-attention): ``LM.loss`` with ``frames`` and every leaf's gradient,
plain and rematted (each encoder and each decoder layer, as the JAX
package's ``_maybe_remat`` wraps both scans' bodies), the microbatched
train step, and ROADMAP.md's R10 on both training launchers, against the
JAX package on the CPU.

The JAX side is ``LM(cfg, tp=1, remat=..., compute_dtype=float32)`` at
the reduced config (``configs/reduce.py``); its parameter tree is carried
into an ``LM(trainable=True)`` by ``convert.lm_params_from_numpy``.
Tokens and ``frames`` come from seeded numpy generators.

Tolerances, with their reasons (stated before the first reading):

- float32 ``loss``: rtol 1e-5; ``acc``: equal;
- every leaf's gradient within 5e-4 of that leaf's largest JAX magnitude
  (JAX against its own ``1 + 1e-7·N(0, 1)`` parameter perturbation moves
  seamless's gradients by up to 2.3e-4; the port read 5.7e-5);
- the train step: the bounds of ``tests/test_torch_lm_train.py``'s step
  test (moments to the gradients' tolerance, ``grad_norm`` rtol 5e-4,
  the other metrics rtol 1e-5, the parameters within a tenth of the
  summed learning rates at every entry and a thousandth of it on
  average).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.reduce import reduced as jreduced
from repro.models.model import LM as JLM
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.step import TrainHParams as JTrainHParams
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.model import LM
from repro_torch.optim import AdamWConfig, cosine_warmup
from repro_torch.train.step import (TrainHParams, init_train_state,
                                    make_train_step)

# one xdist worker per core runs these files beside the JAX suite
torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
GRAD_TOL = 5e-4


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _pair(*, remat=False, seed=1):
    jlm = JLM(jreduced(jget_config(ARCH)), tp=1, remat=remat,
              compute_dtype=jnp.float32)
    params = jlm.init(jax.random.key(seed))
    lm = LM(reduced(get_config(ARCH)), device="cpu", dtype=torch.float32,
            trainable=True, remat=remat)
    lm_params_from_numpy(jax.tree.map(np.asarray, params), lm)
    return jlm, params, lm


def _batch(cfg, rng, b=2, s=20):
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s), np.int32),
            "frames": rng.normal(0, 1, (b, s // cfg.enc_len_ratio,
                                        cfg.d_model)).astype(np.float32),
            "targets": rng.integers(0, cfg.vocab_size, (b, s), np.int32)}


def _held(got_tree, want_tree) -> None:
    for path, w in _flat(want_tree):
        w = np.asarray(w, dtype=np.float32)
        np.testing.assert_allclose(_np(_get(got_tree, path)), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg="/".join(path))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_grads_match_jax(remat):
    """``LM.loss`` with ``frames`` and every leaf's float32 gradient (the
    encoder's and ``enc_norm``'s among them: they reach the loss through
    every decoder layer's cross-attention) against
    ``jax.value_and_grad(lm.loss)``."""
    jlm, params, lm = _pair(remat=remat)
    batch = _batch(lm.cfg, np.random.default_rng(8))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    loss, m = lm.loss({k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    assert float(m["acc"]) == float(jm["acc"])
    for path, w in _flat(jgrads):
        assert np.abs(np.asarray(w)).max() > 0, path
    _held(lm.grads, jgrads)


def test_train_step_two_microbatches_matches_jax():
    """Two steps of the 2-microbatch step (each microbatch its rows of
    tokens and frames) against the jitted JAX step."""
    jlm, params, lm = _pair(seed=3)
    jhp = JTrainHParams(peak_lr=1e-3, warmup=1, total_steps=10, n_micro=2,
                        adamw=JAdamWConfig(clip_norm=5.0))
    hp = TrainHParams(peak_lr=1e-3, warmup=1, total_steps=10, n_micro=2,
                      adamw=AdamWConfig(clip_norm=5.0))
    jstep = jax.jit(jmake_train_step(jlm.loss, jhp))
    step = make_train_step(lm, hp)
    jstate, state = jinit_train_state(params), init_train_state(lm.params)
    rng = np.random.default_rng(5)
    for _ in range(2):
        batch = _batch(lm.cfg, rng, b=4, s=12)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        assert sorted(m) == sorted(jm) == ["acc", "grad_norm", "loss", "lr"]
        for k in m:
            np.testing.assert_allclose(
                float(m[k]), float(jm[k]),
                rtol=5e-4 if k == "grad_norm" else 1e-5)
    assert int(state.step) == int(jstate.step) == 2
    lr_sum = sum(float(cosine_warmup(torch.tensor(i), peak_lr=1e-3,
                                     warmup=1, total=10)) for i in range(2))
    for path, want in _flat(jstate.params):
        diff = np.abs(_np(_get(state.params, path)) - np.asarray(want))
        assert diff.max() <= 0.1 * lr_sum and diff.mean() <= 1e-3 * lr_sum, \
            path
    _held(state.opt.mu, jstate.opt.mu)
    _held(state.opt.nu, jstate.opt.nu)


def test_both_train_launchers_feed_no_frames(tmp_path, monkeypatch):
    """ROADMAP.md, R10: the JAX training launcher feeds its loader's
    tokens and targets and no ``frames``, so seamless fails with
    ``KeyError: 'frames'`` (after ``run_with_recovery``'s retries); the
    port's launcher does the same, with a mesh and without."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", ARCH, "--steps", "1", "--seq", "16",
        "--mesh", "host1", "--ckpt-dir", str(tmp_path / "jax")])
    with pytest.raises(KeyError, match="frames"):
        jtrain.main()
    for mesh in (None, "host4"):
        with pytest.raises(KeyError, match="frames"):
            train.run(ARCH, steps=1, seq=16, device="cpu", mesh=mesh,
                      ckpt_dir=str(tmp_path / f"port-{mesh}"))
