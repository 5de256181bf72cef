"""Port parity for training the moe family (llama4-scout's chunked-local /
global superblocks with routed experts; deepseek-v2's MLA layers, its
dense first layer, then routed experts): ``LM.loss`` and every leaf's
gradient, plain and rematted, and the microbatched train step, against
the JAX package on the same inputs, on the CPU.

The JAX side is ``LM(cfg, tp=1, remat=..., compute_dtype=float32)`` at
the reduced configs (``configs/reduce.py``); its parameter tree is
carried into an ``LM(trainable=True)`` by ``convert.lm_params_from_numpy``.
Inputs come from seeded numpy generators.

Tolerances, with their reasons (stated before the first reading):

- float32 ``loss``: rtol 1e-5; ``acc``: equal;
- every leaf's gradient within ``GRAD_TOL[arch]`` of that leaf's
  largest JAX magnitude: deepseek 5e-4, as the dense and ssm tests;
  llama4 2e-3, set from a control — JAX against itself with every
  parameter scaled by ``1 + 1e-7·N(0, 1)`` moves llama4's gradients by
  up to 1.67e-3 of a leaf's largest entry (``embed``; its top-1 routing
  sums a few tokens per expert, so rounding in the gates carries far).
  The test computes that control on its own inputs and also asserts the
  port lies no further from JAX than ``CONTROL_FACTOR`` (1.5) times it.
  One perturbation is no control: over 16 draws it moved the gradients
  by 3.0e-4 to 4.25e-3 (``embed`` each time), so the control is the
  median over ``CONTROL_DRAWS`` (8) seeded draws;
- llama4's routers (ROADMAP.md, R9): a top-1 weight renormalizes to 1,
  so the router takes no gradient but rounding (about 1e-9 on both
  packages); each is held absolutely, ``|g| <= R9_ABS`` (1e-6) on both;
- ``moe_apply``'s gradient alone (router, experts, shared experts and
  the input) with dropped tokens: 5e-4 of each tensor's largest JAX
  magnitude, as deepseek's leaves; a top-1 router (R9) within 1e-6 of
  the call's largest gradient entry on both packages (its gradient is
  rounding: float32's epsilon times the other gradients' scale);
- routing: as the moe tests' stated precondition, no token's k-th and
  (k+1)-th gates lie within ``GATE_GAP`` (1e-5) on the port (the inputs
  are not re-seeded to pass it);
- the train step: the bounds of ``tests/test_torch_lm_train.py``'s step
  test at ``GRAD_TOL[arch]`` — moments to the gradients' tolerance,
  ``grad_norm`` rtol 5e-4, the other metrics rtol 1e-5, the parameters
  within a tenth of the summed learning rates at every entry and a
  thousandth of it on average.  llama4's routers (R9): moments within
  1e-6 (``mu``) and 1e-12 (``nu``) absolute on both packages, the
  parameters within twice the summed learning rates (AdamW's normalized
  step is below 1 in magnitude, and R9's gradients of ~1e-9 against
  ``eps`` 1e-8 leave its sign to rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.reduce import reduced as jreduced
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models.model import LM as JLM
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.step import TrainHParams as JTrainHParams
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import moe
from repro_torch.models.model import LM
from repro_torch.optim import AdamWConfig, cosine_warmup
from repro_torch.train.step import (TrainHParams, init_train_state,
                                    make_train_step)

# one xdist worker per core runs these files beside the JAX suite
torch.set_num_threads(2)

LLAMA4, DEEPSEEK = "llama4-scout-17b-a16e", "deepseek-v2-236b"
MOE = [LLAMA4, DEEPSEEK]
GRAD_TOL = {LLAMA4: 2e-3, DEEPSEEK: 5e-4}
CONTROL_FACTOR = 1.5
CONTROL_EPS = 1e-7
CONTROL_DRAWS = 8
R9_ABS = 1e-6
GATE_GAP = 1e-5


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


def _gates_apart(gates, k: int) -> None:
    """The stated precondition of a routing comparison."""
    s = -np.sort(-np.asarray(gates, np.float32), axis=-1)
    gap = (s[..., k - 1] - s[..., k]).min()
    assert gap > GATE_GAP, f"a top-k near-tie ({gap:.2e}) in the inputs"


def _r9(arch, path) -> bool:
    """llama4's routers: no gradient but rounding (R9)."""
    return arch == LLAMA4 and path[-1] == "router"


def _pair(arch, *, remat=False, seed=1):
    jlm = JLM(jreduced(jget_config(arch)), tp=1, remat=remat,
              compute_dtype=jnp.float32)
    params = jlm.init(jax.random.key(seed))
    lm = LM(reduced(get_config(arch)), device="cpu", dtype=torch.float32,
            trainable=True, remat=remat)
    lm_params_from_numpy(jax.tree.map(np.asarray, params), lm)
    return jlm, params, lm


def _batch(cfg, rng, b=2, s=20):
    return {k: rng.integers(0, cfg.vocab_size, (b, s), np.int32)
            for k in ("tokens", "targets")}


def _watch_gates(monkeypatch) -> list:
    """Record, for every ``moe_route`` call, the smallest gap between a
    token's k-th and (k+1)-th gates."""
    gaps = []
    real = moe.moe_route

    def watch(c, router, xt):
        r = real(c, router, xt)
        s = torch.sort(r.gates.detach(), -1, descending=True).values
        gaps.append(float((s[:, c.top_k - 1] - s[:, c.top_k]).min()))
        return r
    monkeypatch.setattr(moe, "moe_route", watch)
    return gaps


def _rel_errs(arch, got, want) -> dict:
    """Per leaf (not the R9 routers): max |got − want| over max |want|."""
    out = {}
    for path, w in _flat(want):
        if _r9(arch, path):
            continue
        w = np.asarray(w, dtype=np.float32)
        g = _np(_get(got, path))
        out["/".join(path)] = float(np.abs(g - w).max() / np.abs(w).max())
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_jax(arch, remat, monkeypatch):
    """``LM.loss`` and every leaf's float32 gradient against
    ``jax.value_and_grad(lm.loss)`` (llama4: a superblock is the remat
    body; deepseek: each scanned layer, not the first)."""
    jlm, params, lm = _pair(arch, remat=remat)
    batch = _batch(lm.cfg, np.random.default_rng(8))
    jb = jax.tree.map(jnp.asarray, batch)
    vg = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))
    (jloss, jm), jgrads = vg(params, jb)
    gaps = _watch_gates(monkeypatch)
    loss, m = lm.loss({k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    assert gaps and min(gaps) > GATE_GAP, \
        f"a top-k near-tie ({min(gaps):.2e}) in the inputs"
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    assert float(m["acc"]) == float(jm["acc"])
    for path, w in _flat(jgrads):
        w = np.asarray(w, dtype=np.float32)
        g = _np(_get(lm.grads, path))
        if _r9(arch, path):
            assert np.abs(w).max() <= R9_ABS and np.abs(g).max() <= R9_ABS
            continue
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL[arch] * np.abs(w).max(),
                                   err_msg="/".join(path))
    if arch == LLAMA4:
        draws = []
        for seed in range(CONTROL_DRAWS):
            noise = np.random.default_rng(seed)
            bumped = jax.tree.map(
                lambda p: p * (1 + CONTROL_EPS * jnp.asarray(
                    noise.standard_normal(p.shape), p.dtype)), params)
            _, jgrads2 = vg(bumped, jb)
            draws.append(max(_rel_errs(arch, jgrads2, jgrads).values()))
        control = float(np.median(draws))
        port = max(_rel_errs(arch, lm.grads, jgrads).values())
        assert control > 0
        assert port <= CONTROL_FACTOR * control, (port, control)


@pytest.mark.parametrize("arch", MOE)
def test_train_step_two_microbatches_matches_jax(arch):
    """Two steps of the 2-microbatch step against the jitted JAX step on
    the same weights and batches (each microbatch routes its own tokens,
    as the JAX scan does)."""
    jlm, params, lm = _pair(arch, seed=3)
    tol = GRAD_TOL[arch]
    jhp = JTrainHParams(peak_lr=1e-3, warmup=1, total_steps=10, n_micro=2,
                        adamw=JAdamWConfig(clip_norm=5.0))
    hp = TrainHParams(peak_lr=1e-3, warmup=1, total_steps=10, n_micro=2,
                      adamw=AdamWConfig(clip_norm=5.0))
    jstep = jax.jit(jmake_train_step(jlm.loss, jhp))
    step = make_train_step(lm, hp)
    jstate, state = jinit_train_state(params), init_train_state(lm.params)
    rng = np.random.default_rng(5)
    for _ in range(2):
        batch = _batch(lm.cfg, rng, b=4, s=10)
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
        if _r9(arch, path):
            assert diff.max() <= 2 * lr_sum, path
            continue
        assert diff.max() <= 0.1 * lr_sum and diff.mean() <= 1e-3 * lr_sum, \
            path
    for moment, jmoment, r9 in ((state.opt.mu, jstate.opt.mu, R9_ABS),
                                (state.opt.nu, jstate.opt.nu, R9_ABS ** 2)):
        for path, w in _flat(jmoment):
            w = np.asarray(w, dtype=np.float32)
            g = _np(_get(moment, path))
            if _r9(arch, path):
                assert np.abs(w).max() <= r9 and np.abs(g).max() <= r9
                continue
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=tol * np.abs(w).max(),
                                       err_msg="/".join(path))


@pytest.mark.parametrize("args", [(64, 4, 1, 128, 1, 128),
                                  (64, 8, 2, 64, 2, 128)],
                         ids=["llama4-reduced", "deepseek-reduced"])
def test_moe_apply_grads_with_dropped_tokens_match_jax(args):
    """ROADMAP.md, R7: at (3, 12) tokens that share one direction (router
    scaled by 8) the capacity drops entries (asserted).  The gradient of
    ``<moe_apply(x), cotangent>`` for the router, the experts, the shared
    experts and ``x`` is JAX's: the gates' gradient flows through the
    renormalized top-k weights of the kept entries only, and a dropped
    entry's expert slot receives none."""
    c, jc = moe.MoECfg(*args), jmoe.MoECfg(*args)
    p = jax.tree.map(np.asarray, jcommon.init_params(jmoe.moe_defs(jc),
                                                     jax.random.key(4)))
    p["router"] = (p["router"] * 8.0).astype(np.float32)
    rng = np.random.default_rng(2)
    x = (rng.normal(0, 1, (64,)) + rng.normal(0, 1, (3, 12, 64))) \
        .astype(np.float32)
    ct = rng.normal(0, 1, x.shape).astype(np.float32)
    _gates_apart(jax.nn.softmax(jnp.asarray(x.reshape(-1, 64))
                                @ jnp.asarray(p["router"]), -1), c.top_k)

    def jloss(p, x):
        return jnp.sum(jmoe.moe_apply(jc, p, x) * jnp.asarray(ct))
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), p)
    tx = torch.tensor(x, requires_grad=True)
    r = moe.moe_route(c, tp["router"], tx.reshape(-1, 64))
    assert int((~r.keep).sum()) > 0, "the capacity must drop entries here"
    (moe.moe_apply(c, tp, tx) * torch.as_tensor(ct)).sum().backward()
    scale = max(float(np.abs(v).max()) for v in jax.tree.leaves(jgp))
    for path, w in list(_flat(jax.tree.map(np.asarray, jgp))) + \
            [(("x",), np.asarray(jgx))]:
        got = tx.grad if path == ("x",) else _get(tp, path).grad
        if c.top_k == 1 and path == ("router",):        # R9
            assert np.abs(w).max() <= 1e-6 * scale
            assert float(got.abs().max()) <= 1e-6 * scale
            continue
        np.testing.assert_allclose(_np(got), w, rtol=0,
                                   atol=5e-4 * np.abs(w).max(),
                                   err_msg="/".join(path))
    # a dropped entry's slot holds no token: an expert whose bucket
    # overflows gets the gradient of its first ``cap`` tokens only
    full = torch.bincount(r.sorted_e, minlength=c.n_experts) > r.cap
    assert bool(full.any())
