"""Port parity for the ``ssm`` and ``hybrid`` families (``models/mamba2``
and the mamba2-130m / zamba2-2.7b branches of ``LM``) against the JAX
package on the same inputs, on the CPU, in float32 at the reduced
configs (``configs/reduce.py``).

The JAX side is ``LM(cfg, tp=1, remat=False, compute_dtype=float32)``;
its parameter tree is carried into the port by
``convert.lm_params_from_numpy``.  Inputs come from seeded numpy
generators.

Tolerances, with their reasons:

- the mamba block's pieces (conv, chunked scan, apply, decode), hidden
  states, logits and caches: rtol 1e-4, atol 1e-4 of the compared
  tensor's largest magnitude (at least 1e-4) — XLA and torch sum the
  float32 products of the scan's einsums in another order (max seen:
  8.8e-5 on zamba2's prefill keys of magnitude about 3);
- greedy tokens: equal, except where the JAX logits of the two picks
  lie within ``TIE_F32`` (1e-4);
- ``loss`` rtol 1e-5; the gradient of every leaf within 5e-4 of that
  leaf's largest JAX magnitude (max seen 1.2e-4 on zamba2's ``conv_b``:
  the reduced zamba2 at random init has gradients up to 37 on its
  embedding, and the backward pass sums them in another order);
- prefill against decode (the chunked scan against the recurrence) on
  the port alone, in float32: logits within 1e-4 of the largest, picks
  equal up to ``TIE_F32`` — the reference's own bf16 zamba2 case fails
  its near-tie rule (ROADMAP.md, R3), so the gate is float32.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.reduce import reduced as jreduced
from repro.models import common as jcommon
from repro.models import mamba2 as jmamba
from repro.models.model import LM as JLM
from repro.serve.decode import generate as jgenerate
from repro_torch import tree as ttree
from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import common
from repro_torch.models import mamba2
from repro_torch.models.model import LM
from repro_torch.serve.decode import generate

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

TOL = 1e-4
TIE_F32 = 1e-4
GRAD_TOL = 5e-4
ARCHS = ["mamba2-130m", "zamba2-2.7b"]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _close(got, want) -> None:
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(
        got.detach().float().numpy(), want, rtol=TOL,
        atol=TOL * max(1.0, float(np.abs(want).max(initial=0.0))))


def _tokens_agree(got, want, logits) -> None:
    got, want = np.asarray(got), np.asarray(want)
    logits = np.asarray(logits, dtype=np.float32)
    rows = np.arange(len(want))
    gap = np.abs(logits[rows, got] - logits[rows, want])
    assert ((got == want) | (gap <= TIE_F32)).all(), (got, want, gap)


def _mcfg(arch="mamba2-130m", **kw):
    c = reduced(get_config(arch))
    args = (c.d_model,)
    kw = dict(d_state=c.ssm_state, head_dim=c.ssm_head_dim,
              expand=c.ssm_expand, conv_kernel=c.conv_kernel,
              chunk=c.ssm_chunk, norm_eps=c.norm_eps, **kw)
    return mamba2.MambaCfg(*args, **kw), jmamba.MambaCfg(*args, **kw)


def _block(mc, seed):
    """One mamba block's leaves from the JAX init (float32 numpy),
    ``a_log`` / ``dt_bias`` / ``d_skip`` / ``conv_b`` perturbed off their
    ones and zeros so every term of the block shows."""
    p = jax.tree.map(np.asarray, jcommon.init_params(
        jmamba.mamba_defs(mc), jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for k in ("a_log", "dt_bias", "d_skip", "conv_b"):
        p[k] = (p[k] + rng.normal(0, 0.3, p[k].shape)).astype(np.float32)
    return p


@pytest.fixture(params=ARCHS)
def pair(request):
    """(cfg, JAX LM, its float32 params, the port's float32 LM holding
    them)."""
    jlm = JLM(jreduced(jget_config(request.param)), tp=1, remat=False,
              compute_dtype=jnp.float32)
    params = jlm.init(jax.random.key(0))
    lm = LM(reduced(get_config(request.param)), device="cpu",
            dtype=torch.float32)
    lm_params_from_numpy(jax.tree.map(np.asarray, params), lm)
    return lm.cfg, jlm, params, lm


# -- the mamba block ---------------------------------------------------------


def test_causal_conv_matches_jax():
    mc, jmc = _mcfg()
    p = _block(mc, 1)
    xbc = np.random.default_rng(2).normal(0, 1, (2, 11, mc.conv_dim)) \
        .astype(np.float32)
    _close(mamba2._causal_conv(mc, jax.tree.map(_t, p), _t(xbc)),
           jmamba._causal_conv(jmc, p, jnp.asarray(xbc)))


@pytest.mark.parametrize("s", [32, 21, 7], ids=["2-chunks", "ragged",
                                               "short"])
def test_ssd_chunk_scan_matches_jax(s):
    """The chunked scan at two whole chunks of 16, and at S = 21 and 7
    padded to the chunk as ``mamba_apply`` pads (dt = 0 on the padding:
    the identity update), with a carried-in state."""
    mc, jmc = _mcfg()
    rng = np.random.default_rng(s)
    h, pd, n = mc.n_heads, mc.head_dim, mc.d_state
    q = min(mc.chunk, s)
    sp = -(-s // q) * q
    x = rng.normal(0, 1, (2, sp, h, pd)).astype(np.float32)
    dt = np.abs(rng.normal(0, 0.5, (2, sp, h))).astype(np.float32)
    dt[:, s:] = 0.0
    b_in = rng.normal(0, 1, (2, sp, n)).astype(np.float32)
    c_in = rng.normal(0, 1, (2, sp, n)).astype(np.float32)
    a = -np.exp(rng.normal(0, 0.5, (h,))).astype(np.float32)
    h0 = rng.normal(0, 1, (2, h, pd, n)).astype(np.float32)
    y, hf = mamba2._ssd_chunk_scan(mc, *map(_t, (x, dt, b_in, c_in, a, h0)))
    jy, jhf = jmamba._ssd_chunk_scan(jmc, *map(jnp.asarray,
                                               (x, dt, b_in, c_in, a, h0)))
    assert y.dtype == hf.dtype == torch.float32
    _close(y, jy)
    _close(hf, jhf)
    if sp != s:
        with pytest.raises(ValueError, match="multiple of the chunk"):
            mamba2._ssd_chunk_scan(mc, *map(_t, (x[:, :s], dt[:, :s],
                                                 b_in[:, :s], c_in[:, :s],
                                                 a, h0)))


@pytest.mark.parametrize("s", [21, 2], ids=["ragged", "shorter-than-conv"])
def test_mamba_apply_and_decode_match_jax(s):
    """``mamba_apply`` (output, the conv state — shorter than K−1 when
    S < K−1, sliced as written — and the final SSM state), then eight
    ``mamba_decode`` steps from a zero state."""
    mc, jmc = _mcfg()
    p = _block(mc, 3)
    tp, jp = jax.tree.map(_t, p), jax.tree.map(jnp.asarray, p)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, s, mc.d_model)).astype(np.float32)
    y, (cs, hf) = mamba2.mamba_apply(mc, tp, _t(x))
    jy, (jcs, jhf) = jmamba.mamba_apply(jmc, jp, jnp.asarray(x))
    assert tuple(cs.shape) == jcs.shape == (2, mc.conv_dim,
                                            min(s, mc.conv_kernel - 1))
    _close(y, jy)
    _close(cs, jcs)
    _close(hf, jhf)
    h0 = rng.normal(0, 1, hf.shape).astype(np.float32)
    _close(mamba2.mamba_apply(mc, tp, _t(x), h0=_t(h0))[0],
           jmamba.mamba_apply(jmc, jp, jnp.asarray(x), h0=jnp.asarray(h0))[0])
    conv, ssm = mamba2.mamba_init_state(mc, 2, dtype=torch.float32)
    jconv, jssm = jmamba.mamba_init_state(jmc, 2, dtype=jnp.float32)
    assert ssm.dtype == torch.float32 and tuple(conv.shape) == jconv.shape
    for t in range(8):
        xt = rng.normal(0, 1, (2, 1, mc.d_model)).astype(np.float32)
        y, conv, ssm = mamba2.mamba_decode(mc, tp, _t(xt), conv, ssm)
        jy, jconv, jssm = jmamba.mamba_decode(jmc, jp, jnp.asarray(xt),
                                              jconv, jssm)
        _close(y, jy)
        _close(conv, jconv)
        _close(ssm, jssm)


# -- the LM ------------------------------------------------------------------


def test_param_defs_and_storage_equal_jax(pair):
    """The parameter tree (shapes, inits, scales; zamba2's ``blocks``
    stacked (superblock, layer)) is JAX's; vectors are stored float32,
    matrices in the compute dtype."""
    cfg, jlm, params, lm = pair
    flat = common.flatten_defs(lm.param_defs())
    jflat = jax.tree.flatten_with_path(
        jlm.param_defs(), is_leaf=lambda d: isinstance(d, jcommon.ParamDef))[0]
    assert [(p, tuple(d)) for p, d in flat] == \
        [(tuple(k.key for k in path), tuple(d)) for path, d in jflat]
    assert common.count_params(lm) == jcommon.count_params(params)
    bf = LM(cfg, device="meta", dtype=torch.bfloat16)
    for path, d in flat:
        stacked = sum(a == "layers" for a in d.axes)
        leaf = bf.params
        for k in path:
            leaf = leaf[k]
        want = torch.float32 if len(d.shape) - stacked <= 1 \
            else torch.bfloat16
        assert leaf.dtype == want, path
        assert len(bf.leaf_parameters(path)) == \
            int(np.prod(d.shape[:stacked])), path


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_count_equals_jax(arch):
    lm = LM(get_config(arch), device="meta", dtype=torch.bfloat16)
    jdefs = JLM(jget_config(arch), tp=1, remat=False).param_defs()
    jn = sum(int(np.prod(d.shape)) for d in jax.tree.leaves(
        jdefs, is_leaf=lambda d: isinstance(d, jcommon.ParamDef)))
    assert common.count_params(lm) == jn


def test_prefill_logits_and_cache_match_jax(pair):
    """Hidden states, the last logits, the greedy token and the prefill
    cache (mamba2: per-layer conv / SSM states; zamba2: those stacked
    (superblock, layer), and each site's keys and values) at S = 21
    (a ragged last chunk)."""
    cfg, jlm, params, lm = pair
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 21),
                                             np.int32)
    jh, _ = jax.jit(lambda p, t: jlm._forward(p, t))(params,
                                                      jnp.asarray(toks))
    h, _ = lm._forward(_t(toks))
    _close(h, jh)
    jlogits = jlm._logits(params, jh[:, -1:])[:, 0]
    _close(lm._logits(h[:, -1:])[:, 0], jlogits)
    jtok, jcache = jax.jit(jlm.prefill)(params, {"tokens": jnp.asarray(toks)})
    tok, cache = lm.prefill({"tokens": _t(toks)})
    _tokens_agree(tok.numpy(), jtok, jlogits)
    assert str(jax.tree.structure(jcache)) == ttree.flatten(cache)[1]
    for got, want in zip(ttree.leaves(cache), jax.tree.leaves(jcache)):
        assert tuple(got.shape) == want.shape
        _close(got, want)


def test_decode_steps_and_generate_match_jax(pair):
    """Twenty decode steps (tokens and every cache leaf; zamba2's SSM
    state float32, its attention caches per site), then ``generate``."""
    cfg, jlm, params, lm = pair
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 20),
                                             np.int32)
    cache, jcache = lm.init_cache(2, 24), jlm.init_cache(2, 24)
    assert ttree.flatten(cache)[1] == str(jax.tree.structure(jcache))
    assert cache["ssm"].dtype == torch.float32
    jstep, jlogits = jax.jit(jlm.decode_step), jax.jit(jlm._logits)
    for pos in range(20):
        t = toks[:, pos:pos + 1]
        jnxt, jcache2 = jstep(params, jcache, jnp.asarray(t), jnp.int32(pos))
        h = lm._decode_hidden({k: ttree.map(torch.clone, v)
                               for k, v in cache.items()}, _t(t), pos)
        logits = jlogits(params, jnp.asarray(h.numpy()))[:, 0]
        nxt, cache = lm.decode_step(cache, _t(t), pos)
        _tokens_agree(nxt.numpy(), jnxt, logits)
        for got, want in zip(ttree.leaves(cache), jax.tree.leaves(jcache2)):
            _close(got, want)
        jcache = jcache2
    want = jax.jit(lambda p, t: jgenerate(jlm, p, t, max_new=5))(
        params, jnp.asarray(toks[:, :10]))
    got = generate(lm, _t(toks[:, :10]), max_new=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_against_decode_float32(pair):
    """The chunked scan (prefill over 17 tokens: one whole chunk and a
    ragged one) against the recurrence (17 decode steps) on the port:
    last logits within 1e-4 of the largest, greedy picks equal up to
    near ties."""
    cfg, _, _, lm = pair
    toks = _t(np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 17),
                                                np.int32))
    h, _ = lm._forward(toks)
    logits = lm._logits(h[:, -1:])[:, 0]
    cache = lm.init_cache(2, 17)
    for pos in range(16):
        lm.decode_step(cache, toks[:, pos:pos + 1], pos)
    dlogits = lm._logits(lm._decode_hidden(cache, toks[:, 16:], 16))[:, 0]
    _close(dlogits, logits.numpy())
    _tokens_agree(dlogits.argmax(-1).numpy(), logits.argmax(-1).numpy(),
                  logits.numpy())


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    """``LM.loss`` and every leaf's float32 gradient against
    ``jax.value_and_grad(lm.loss)`` (zamba2: only the superblock body is
    rematted, and the shared block's gradient sums its nine sites)."""
    jlm = JLM(jreduced(jget_config(arch)), tp=1, remat=remat,
              compute_dtype=jnp.float32)
    params = jlm.init(jax.random.key(1))
    lm = LM(reduced(get_config(arch)), device="cpu", dtype=torch.float32,
            trainable=True, remat=remat)
    lm_params_from_numpy(jax.tree.map(np.asarray, params), lm)
    rng = np.random.default_rng(8)
    batch = {k: rng.integers(0, lm.cfg.vocab_size, (2, 20), np.int32)
             for k in ("tokens", "targets")}
    (jloss, jm), jgrads = jax.value_and_grad(jlm.loss, has_aux=True)(
        params, jax.tree.map(jnp.asarray, batch))
    loss, m = lm.loss({k: _t(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    assert float(m["acc"]) == float(jm["acc"])
    got, want = ttree.leaves(lm.grads), jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_shapes_no_nans(arch):
    """The JAX smoke test's train-step case for these families: finite
    loss and accuracy, nonzero gradients, bf16 compute."""
    lm = LM(reduced(get_config(arch)), device="cpu", trainable=True)
    lm.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    loss, m = lm.loss({k: _t(rng.integers(0, lm.cfg.vocab_size, (2, 32),
                                          np.int32))
                       for k in ("tokens", "targets")})
    loss.backward()
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["acc"]))
    gn = sum(float(g.abs().sum()) for g in ttree.leaves(lm.grads))
    assert np.isfinite(gn) and gn > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_the_families_on_cpu(arch, tmp_path, capsys):
    """``launch.serve`` and ``launch.train`` take ``--arch`` of both
    families (reduced widths, ``--device cpu``)."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    res = serve_main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--max-new", "4"])
    assert tuple(res["out"].shape) == (2, 4)
    res = train_main(["--arch", arch, "--device", "cpu", "--steps", "3",
                      "--seq", "16", "--global-batch", "2",
                      "--ckpt-dir", str(tmp_path)])
    assert int(res["state"].step) == 3 and np.isfinite(res["losses"]).all()
    out = capsys.readouterr().out
    assert f"{arch}-smoke: (2, 4) in" in out
    assert "training complete; final step 3" in out
