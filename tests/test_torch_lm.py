"""Port parity for the LM zoo's dense family (``models/common``,
``models/attention``, the SwiGLU MLP, ``models/model.LM``,
``serve/decode.generate``, ``launch/serve``) against the JAX package on
the same inputs, on the CPU.

The JAX side is ``LM(cfg, tp=..., remat=False, compute_dtype=float32)``
at the reduced configs (``configs/reduce.py``); its parameter tree is
carried into the port by ``convert.lm_params_from_numpy``.  Inputs come
from seeded numpy generators.

Tolerances, with their reasons:

- float32 paths (norms, RoPE, attention, the blocks, logits, KV caches):
  rtol 1e-4, atol 1e-4 — XLA and torch sum float32 products in another
  order, and the errors of a few chained products and softmaxes stay
  far inside this (max seen: 1.2e-4 absolute on internvl2's prefix
  cache entries of magnitude about 5, 7e-5 on logits);
- greedy tokens (``prefill``, ``decode_step``, ``generate``): equal,
  except where the JAX logits of the two picks lie within ``TIE_F32``
  (1e-4) of each other;
- the one bfloat16 case: the near-tie rule of
  ``tests/test_models_smoke.py::test_prefill_decode_consistency``
  (``NEAR_TIE_BF16 = 0.06``, a few bfloat16 ulps at the logit scale of a
  random-init model): a pick may differ only where its logit is within
  that of the top.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.configs.reduce import reduced as jreduced
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models.model import LM as JLM
from repro.models.moe import mlp_apply as jmlp_apply
from repro.serve.decode import generate as jgenerate
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.reduce import reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models.model import LM
from repro_torch.models.moe import mlp_apply
from repro_torch.serve.decode import generate

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

RTOL = ATOL = 1e-4
TIE_F32 = 1e-4
NEAR_TIE_BF16 = 0.06
DENSE = ["tinyllama-1.1b", "qwen1.5-4b", "qwen1.5-110b", "starcoder2-7b",
         "internvl2-26b"]
OTHER = ["llama4-scout-17b-a16e", "deepseek-v2-236b", "zamba2-2.7b",
         "seamless-m4t-large-v2", "mamba2-130m"]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _close(got: torch.Tensor, want, **kw) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=kw.get("rtol", RTOL),
                               atol=kw.get("atol", ATOL))


def _tokens_agree(got, want, logits, tol) -> None:
    """``got == want`` except near ties: the reference ``logits`` (B, V)
    of both picks within ``tol`` of each other."""
    got, want = np.asarray(got), np.asarray(want)
    logits = np.asarray(logits, dtype=np.float32)
    rows = np.arange(len(want))
    gap = np.abs(logits[rows, got] - logits[rows, want])
    assert ((got == want) | (gap <= tol)).all(), (got, want, gap)


# -- configs -----------------------------------------------------------------


def test_registry_equals_jax():
    assert list_configs() == jlist_configs()


@pytest.mark.parametrize("arch", DENSE + OTHER)
def test_lm_config_and_reduced_equal_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(reduced(get_config(arch))) == \
        dataclasses.asdict(jreduced(jget_config(arch)))


# -- numerics ----------------------------------------------------------------


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rms_norm(eps):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3, (2, 5, 64)).astype(np.float32)
    w = rng.normal(1, 0.1, (64,)).astype(np.float32)
    _close(common.rms_norm(_t(x), _t(w), eps),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), eps))


@pytest.mark.parametrize("pos_shape", [(7,), (2, 7)])
def test_rotary_and_apply_rope(pos_shape):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 5000, pos_shape).astype(np.int32)
    cos, sin = common.rotary(_t(pos), 16, 1e4)
    jcos, jsin = jcommon.rotary(jnp.asarray(pos), 16, 1e4)
    # angles up to 5000 rad: float32 cos/sin of one float32 product
    _close(cos, jcos, atol=2e-4)
    _close(sin, jsin, atol=2e-4)
    x = rng.normal(0, 1, (2, 7, 3, 16)).astype(np.float32)
    _close(common.apply_rope(_t(x), cos, sin),
           jcommon.apply_rope(jnp.asarray(x), jcos, jsin), atol=4e-4)


# (kind, window, chunk, hq, hkv, sq, sk, q_offset)
ATTN_CASES = [
    ("causal", 0, 0, 4, 4, 9, 9, 0),
    ("causal", 0, 0, 8, 2, 9, 9, 0),
    ("bidir", 0, 0, 4, 2, 6, 11, 0),
    ("causal", 4, 0, 4, 2, 13, 13, 0),
    ("causal", 0, 4, 4, 4, 13, 13, 0),
    ("causal", 0, 0, 4, 2, 3, 12, 9),
]


def _qkv(rng, hq, hkv, sq, sk, d=8):
    return (rng.normal(0, 1, (2, sq, hq, d)).astype(np.float32),
            rng.normal(0, 1, (2, sk, hkv, d)).astype(np.float32),
            rng.normal(0, 1, (2, sk, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention(case):
    kind, window, chunk, hq, hkv, sq, sk, off = case
    q, k, v = _qkv(np.random.default_rng(3), hq, hkv, sq, sk)
    kw = dict(kind=kind, window=window, chunk=chunk, q_offset=off)
    _close(common.attention(_t(q), _t(k), _t(v), **kw),
           jcommon.attention(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), **kw))


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_blockwise_attention(case):
    """kv_block 5: several blocks and a ragged last block."""
    kind, window, chunk, hq, hkv, sq, sk, off = case
    q, k, v = _qkv(np.random.default_rng(4), hq, hkv, sq, sk)
    kw = dict(kind=kind, window=window, chunk=chunk, q_offset=off)
    got = common.blockwise_attention(_t(q), _t(k), _t(v), kv_block=5, **kw)
    _close(got, jcommon.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_block=5, **kw))
    _close(got, common.attention(_t(q), _t(k), _t(v), **kw))


@pytest.mark.parametrize("kind,window,chunk", [
    ("causal", 0, 0), ("bidir", 0, 0), ("causal", 5, 0), ("causal", 0, 4),
    ("bidir", 3, 4)])
def test_mask(kind, window, chunk):
    qpos = np.arange(3, 12, dtype=np.int32)
    kpos = np.arange(14, dtype=np.int32)
    np.testing.assert_array_equal(
        common._mask(_t(qpos), _t(kpos), kind, window, chunk).numpy(),
        np.asarray(jcommon._mask(jnp.asarray(qpos), jnp.asarray(kpos), kind,
                                 window, chunk)))


@pytest.mark.parametrize("rep", [1, 3])
def test_expand_kv(rep):
    k = np.random.default_rng(15).normal(0, 1, (2, 5, 4, 8)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        common.expand_kv(_t(k), rep).numpy(),
        np.asarray(jcommon.expand_kv(jnp.asarray(k), rep)))


def test_swiglu_mlp():
    rng = np.random.default_rng(5)
    p = {n: rng.normal(0, 0.2, s).astype(np.float32)
         for n, s in (("w1", (16, 24)), ("w3", (16, 24)), ("w2", (24, 16)))}
    x = rng.normal(0, 1, (2, 3, 16)).astype(np.float32)
    _close(mlp_apply({n: _t(a) for n, a in p.items()}, _t(x)),
           jmlp_apply({n: jnp.asarray(a) for n, a in p.items()},
                      jnp.asarray(x)))


# -- the attention block -----------------------------------------------------


@pytest.mark.parametrize("heads,kv,tp", [
    (4, 2, 1), (4, 4, 3), (6, 2, 4), (4, 2, 3), (20, 20, 16), (32, 4, 16),
    (36, 4, 16), (48, 8, 16), (64, 8, 16), (8, 8, 1)])
def test_head_padding_arithmetic(heads, kv, tp):
    """``hkv``, ``rep``, ``hq`` and the head mask are the JAX package's —
    (4, 2, tp=3) included, where the reference keeps 2 of 4 query heads
    (ROADMAP.md, R4)."""
    c = attn.AttnCfg(64, heads, kv, 16, tp=tp)
    jc = jattn.AttnCfg(64, heads, kv, 16, tp=tp)
    assert (c.g, c.hkv, c.rep, c.hq) == (jc.g, jc.hkv, jc.rep, jc.hq)
    np.testing.assert_array_equal(c.head_mask().numpy(),
                                  np.asarray(jc.head_mask()))


# (name, AttnCfg kwargs, decode steps, cache length)
BLOCK_CASES = [
    ("full", dict(n_heads=4, n_kv_heads=2, qkv_bias=True, tp=1), 12, 12),
    ("window-ring", dict(n_heads=4, n_kv_heads=2, window=16, tp=1), 40, 16),
    ("chunk-ring", dict(n_heads=4, n_kv_heads=2, chunk=8, tp=1), 20, 8),
    ("pad-mha-tp3", dict(n_heads=4, n_kv_heads=4, qkv_bias=True, tp=3),
     10, 10),
    ("pad-group-tp4", dict(n_heads=6, n_kv_heads=2, tp=4), 10, 10),
    ("clamp", dict(n_heads=4, n_kv_heads=2, tp=1), 9, 6),
]


def _block(kw, seed):
    """Both packages' configs and one parameter tree (JAX's init, biases
    made nonzero so their path is exercised)."""
    c = attn.AttnCfg(64, head_dim=16, **kw)
    jc = jattn.AttnCfg(64, head_dim=16, **kw)
    tree = jax.tree.map(np.asarray, jcommon.init_params(
        jattn.attn_defs(jc), jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    tree = {k: (rng.normal(0, 0.3, a.shape).astype(np.float32)
                if k.startswith("b") else a) for k, a in tree.items()}
    return c, jc, tree


@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: c[0])
def test_attn_apply(case):
    name, kw, _, _ = case
    c, jc, tree = _block(kw, 6)
    assert c.hq == jc.hq and \
        {k: a.shape for k, a in tree.items()} == \
        {k: d.shape for k, d in attn.attn_defs(c).items()}
    x = np.random.default_rng(7).normal(0, 1, (2, 11, 64)).astype(np.float32)
    y, (k, v) = attn.attn_apply(c, {n: _t(a) for n, a in tree.items()},
                                _t(x), q_offset=3)
    jy, (jk, jv) = jattn.attn_apply(
        jc, {n: jnp.asarray(a) for n, a in tree.items()}, jnp.asarray(x),
        q_offset=3)
    _close(y, jy)
    _close(k, jk)
    _close(v, jv)


@pytest.mark.parametrize("case", BLOCK_CASES[:2], ids=lambda c: c[0])
def test_attn_apply_blockwise_branch(case, monkeypatch):
    """Past ``BLOCKWISE_THRESHOLD`` both packages switch to the
    online-softmax path (the threshold lowered to 8 on both sides, so an
    11-token sequence takes it)."""
    name, kw, _, _ = case
    c, jc, tree = _block(kw, 16)
    monkeypatch.setattr(attn, "BLOCKWISE_THRESHOLD", 8)
    monkeypatch.setattr(jattn, "BLOCKWISE_THRESHOLD", 8)
    calls = []
    monkeypatch.setattr(attn, "blockwise_attention",
                        lambda *a, **k: calls.append(1) or
                        common.blockwise_attention(*a, **k))
    x = np.random.default_rng(17).normal(0, 1, (2, 11, 64)) \
        .astype(np.float32)
    y, _ = attn.attn_apply(c, {n: _t(a) for n, a in tree.items()}, _t(x))
    jy, _ = jattn.attn_apply(jc, {n: jnp.asarray(a) for n, a in tree.items()},
                             jnp.asarray(x))
    assert calls == [1]
    _close(y, jy)


@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: c[0])
def test_attn_decode(case):
    """Step by step from a zero cache: the full cache, the window ring
    and the chunk ring across wraps, padded heads, and positions past a
    full cache (``dynamic_update_slice`` clamps to the last slot)."""
    name, kw, steps, s_cache = case
    c, jc, tree = _block(kw, 8)
    p = {n: _t(a) for n, a in tree.items()}
    jp = {n: jnp.asarray(a) for n, a in tree.items()}
    xs = np.random.default_rng(9).normal(0, 1, (steps, 2, 1, 64)) \
        .astype(np.float32)
    ck = torch.zeros((2, s_cache, c.hkv, 16))
    cv = torch.zeros_like(ck)
    jck, jcv = jnp.zeros(ck.shape), jnp.zeros(cv.shape)
    step = jax.jit(lambda p, x, a, b, pos: jattn.attn_decode(jc, p, x, a, b,
                                                             pos))
    for pos in range(steps):
        y, ck, cv = attn.attn_decode(c, p, _t(xs[pos]), ck, cv, pos)
        jy, jck, jcv = step(jp, jnp.asarray(xs[pos]), jck, jcv,
                            jnp.int32(pos))
        _close(y, jy)
        _close(ck, jck)
        _close(cv, jcv)


# -- the LM ------------------------------------------------------------------


def _pair(cfg, jcfg, tp=1, seed=0):
    jlm = JLM(jcfg, tp=tp, remat=False, compute_dtype=jnp.float32)
    params = jlm.init(jax.random.key(seed))
    lm = LM(cfg, tp=tp, device="cpu", dtype=torch.float32)
    lm_params_from_numpy(jax.tree.map(np.asarray, params), lm)
    return jlm, params, lm


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    cfg = reduced(get_config(request.param))
    jcfg = jreduced(jget_config(request.param))
    return (cfg,) + _pair(cfg, jcfg)


def _batch(cfg, rng, b=2, s=12):
    toks = rng.integers(0, cfg.vocab_size, (b, s), np.int32)
    out = {"tokens": toks}
    if cfg.prefix_len:
        out["prefix"] = rng.normal(0, 1, (b, cfg.prefix_len, cfg.d_model)) \
            .astype(np.float32)
    return out


def test_param_defs_equal_jax(dense):
    """The parameter tree's shapes, inits and scales are JAX's, and
    ``init`` fills every leaf as its definition says."""
    cfg, jlm, params, lm = dense
    flat = common.flatten_defs(lm.param_defs())
    jflat = jax.tree.flatten_with_path(
        jlm.param_defs(), is_leaf=lambda d: isinstance(d, jcommon.ParamDef))[0]
    assert [(p, tuple(d)) for p, d in flat] == \
        [(tuple(k.key for k in path), tuple(d)) for path, d in jflat]
    assert common.count_params(lm) == jcommon.count_params(params)
    lm2 = LM(cfg, device="cpu", dtype=torch.bfloat16)
    lm2.init(torch.Generator().manual_seed(0))
    assert common.count_params(lm2) == jcommon.count_params(params)
    for path, d in flat:
        ps = lm2.leaf_parameters(path)
        t = torch.stack([p.float() for p in ps]) if path[0] == "layers" \
            else ps[0].float()
        assert tuple(t.shape) == d.shape, path
        assert ps[0].dtype == (torch.float32 if d.init == "ones"
                               else torch.bfloat16), path
        if d.init != "normal":
            assert (t == (1.0 if d.init == "ones" else 0.0)).all(), path
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            want = d.scale if d.scale is not None else fan_in ** -0.5
            assert abs(float(t.std()) / want - 1) < 0.05, path


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_param_count_equals_jax(arch):
    """At the published widths, counted from the definitions (nothing
    allocated: the port's tree is built on the meta device)."""
    cfg = get_config(arch)
    lm = LM(cfg, device="meta", dtype=torch.bfloat16)
    jdefs = JLM(jget_config(arch), tp=1, remat=False).param_defs()
    jn = sum(int(np.prod(d.shape)) for d in jax.tree.leaves(
        jdefs, is_leaf=lambda d: isinstance(d, jcommon.ParamDef)))
    assert common.count_params(lm) == jn


def test_prefill_matches_jax(dense):
    cfg, jlm, params, lm = dense
    b = _batch(cfg, np.random.default_rng(10))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(v) for k, v in b.items()}
    jtok, (jk, jv) = jax.jit(jlm.prefill)(params, jb)
    tok, (k, v) = lm.prefill(tb)
    h, _ = lm._forward(tb["tokens"], prefix=tb.get("prefix"))
    jh, _ = jax.jit(lambda p, t, pre: jlm._forward(p, t, prefix=pre))(
        params, jb["tokens"], jb.get("prefix"))
    logits = lm._logits(h[:, -1:])[:, 0]
    jlogits = jlm._logits(params, jh[:, -1:])[:, 0]
    _close(h, jh)
    _close(logits, jlogits)
    _tokens_agree(tok.numpy(), jtok, jlogits, TIE_F32)
    assert tok.dtype == torch.int32
    _close(k, jk)
    _close(v, jv)


def test_init_cache_and_decode_match_jax(dense):
    """``init_cache`` has JAX's structure, shapes and dtype (a window
    config keeps ``window`` slots); 20 decode steps from it agree, the
    ring buffer of starcoder2's reduced window (16) wrapping once."""
    cfg, jlm, params, lm = dense
    s = 20
    cache = lm.init_cache(2, s)
    jcache = jlm.init_cache(2, s)
    assert set(cache) == set(jcache)
    for n in cache:
        assert tuple(cache[n].shape) == jcache[n].shape
        assert cache[n].dtype == torch.float32
        assert not cache[n].any()
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, s),
                                              np.int32)
    step = jax.jit(jlm.decode_step)
    jhid = jax.jit(lambda p, c, t, pos: jlm._logits(
        p, _jax_hidden(jlm, p, c, t, pos)))
    for pos in range(s):
        jlog = jhid(params, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                    jnp.int32(pos))[:, 0]
        jtok, jcache = step(params, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                            jnp.int32(pos))
        tok, cache = lm.decode_step(cache, _t(toks[:, pos:pos + 1]), pos)
        _tokens_agree(tok.numpy(), jtok, jlog, TIE_F32)
        _close(cache["k"], jcache["k"])
        _close(cache["v"], jcache["v"])


def _jax_hidden(jlm, params, cache, token, pos):
    """The JAX decode step's final-normed hidden state (the body of
    ``LM.decode_step`` for the dense family, before its logits)."""
    c = jlm.cfg
    x = jlm._embed(params, token)

    def body(x, xs):
        lp, ck, cv = xs
        a, ck, cv = jattn.attn_decode(jlm.attn_cfg, lp["attn"],
                                      jcommon.rms_norm(x, lp["ln1"],
                                                       c.norm_eps),
                                      ck, cv, pos)
        x = x + a
        x = x + jmlp_apply(lp["mlp"], jcommon.rms_norm(x, lp["ln2"],
                                                       c.norm_eps))
        return x, None
    x, _ = jax.lax.scan(body, x, (params["layers"], cache["k"], cache["v"]))
    return jcommon.rms_norm(x, params["final_norm"], c.norm_eps)


def test_generate_matches_jax(dense):
    cfg, jlm, params, lm = dense
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 10),
                                              np.int32)
    want = jax.jit(lambda p, t: jgenerate(jlm, p, t, max_new=6))(
        params, jnp.asarray(toks))
    got = generate(lm, _t(toks), max_new=6)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_padded_heads_lm_matches_jax():
    """A tree the JAX ``LM`` made at tp=3 (MHA 4 heads → 6, 2 of them
    masked) loads and decodes the same."""
    jcfg = dataclasses.replace(jreduced(jget_config("qwen1.5-4b")),
                               n_kv_heads=4)
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-4b")),
                              n_kv_heads=4)
    jlm, params, lm = _pair(cfg, jcfg, tp=3)
    assert lm.attn_cfg.hq == 6 and lm.layers[0].attn["wq"].shape[1] == 6
    b = _batch(cfg, np.random.default_rng(13))
    jtok, jcache = jax.jit(jlm.prefill)(params, {"tokens": b["tokens"]})
    tok, cache = lm.prefill({"tokens": _t(b["tokens"])})
    _close(cache[0], jcache[0])
    toks = b["tokens"]
    want = jax.jit(lambda p, t: jgenerate(jlm, p, t, max_new=4))(
        params, jnp.asarray(toks))
    np.testing.assert_array_equal(generate(lm, _t(toks), max_new=4).numpy(),
                                  np.asarray(want))


def test_bf16_prefill_and_decode_near_ties():
    """bfloat16 compute on both sides, the JAX smoke test's near-tie
    rule: the port's prefill picks against JAX's bf16 logits, and the
    port's decode picks after 16 steps against its own prefill logits."""
    jcfg = jreduced(jget_config("qwen1.5-4b"))
    cfg = reduced(get_config("qwen1.5-4b"))
    jlm = JLM(jcfg, tp=1, remat=False, compute_dtype=jnp.bfloat16)
    params = jlm.init(jax.random.key(0))
    lm = LM(cfg, device="cpu", dtype=torch.bfloat16)
    lm_params_from_numpy(jax.tree.map(np.asarray, params), lm)
    b, s = 2, 16
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (b, s + 1),
                                              np.int32)
    jh, _ = jax.jit(lambda p, t: jlm._forward(p, t))(
        params, jnp.asarray(toks[:, :s]))
    jlogits = np.asarray(jlm._logits(params, jh[:, -1:])[:, 0], np.float32)
    tok, _ = lm.prefill({"tokens": _t(toks[:, :s])})
    rows = np.arange(b)
    assert (jlogits[rows, tok.numpy()] >=
            jlogits.max(-1) - NEAR_TIE_BF16).all()
    h, _ = lm._forward(_t(toks[:, :s]))
    logits = lm._logits(h[:, -1:])[:, 0].numpy()
    cache = lm.init_cache(b, s + 1)
    for t in range(s):
        nxt, cache = lm.decode_step(cache, _t(toks[:, t:t + 1]), t)
    assert (logits[rows, nxt.numpy()] >= logits.max(-1) - NEAR_TIE_BF16).all()


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_raise(arch):
    """Every family builds now (the name is kept from when ``moe`` and
    ``encdec`` raised): each config's reduced and published trees build
    on the meta device, and ``FAMILIES`` names its family (their
    parity: ``tests/test_torch_lm_ssm.py``, ``test_torch_lm_moe.py``,
    ``test_torch_lm_encdec.py``)."""
    from repro_torch.models.model import FAMILIES
    for cfg in (reduced(get_config(arch)), get_config(arch)):
        assert cfg.family in FAMILIES
        lm = LM(cfg, device="meta")
        assert lm.cfg.family == cfg.family
        assert all(p.device.type == "meta" for p in lm.parameters())


def test_lm_params_from_numpy_rejects_bad_trees():
    cfg = reduced(get_config("tinyllama-1.1b"))
    jlm = JLM(jreduced(jget_config("tinyllama-1.1b")), tp=1, remat=False)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.key(0)))
    lm = LM(cfg, device="cpu", dtype=torch.float32)
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="missing \\['lm_head'\\]"):
        lm_params_from_numpy(missing, lm)
    extra = dict(tree, layers=dict(tree["layers"], ln3=tree["final_norm"]))
    with pytest.raises(ValueError, match="extra \\['layers/ln3'\\]"):
        lm_params_from_numpy(extra, lm)
    bad = dict(tree, final_norm=tree["final_norm"][:-1])
    with pytest.raises(ValueError, match="final_norm: expected"):
        lm_params_from_numpy(bad, lm)
    ints = dict(tree, final_norm=tree["final_norm"].astype(np.int32))
    with pytest.raises(ValueError, match="final_norm: expected a float"):
        lm_params_from_numpy(ints, lm)


# -- the launcher ------------------------------------------------------------


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch.serve import main
    res = main(["--device", "cpu", "--arch", "tinyllama-1.1b", "--batch",
                "2", "--prompt-len", "6", "--max-new", "3"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"tinyllama-1\.1b-smoke: \(2, 3\) in \d+ ms "
                        r"\([\d,]+ tok/s\)", line), line
    out = res["out"]
    assert tuple(out.shape) == (2, 3) and out.device.type == "cpu"
    assert int(out.min()) >= 0 and int(out.max()) < res["cfg"].vocab_size
    np.testing.assert_array_equal(
        res["prompts"].numpy(),
        np.random.default_rng(0).integers(0, res["cfg"].vocab_size, (2, 6),
                                          np.int32))


def test_serve_launcher_without_gpu_raises():
    """``--device`` defaults to cuda: without a GPU the launcher and the
    model raise rather than quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-GPU path cannot be shown")
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--max-new", "1"])
    with pytest.raises(RuntimeError, match="is_available"):
        LM(reduced(get_config("qwen1.5-4b")))
