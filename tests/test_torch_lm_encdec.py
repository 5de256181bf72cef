"""Port parity for the ``encdec`` family (seamless-m4t-large-v2: the
bidirectional encoder over ``frames``, the decoder's self- and
cross-attention, the ``xk`` / ``xv`` cache) against the JAX package on
the same inputs, on the CPU, in float32 at the reduced config
(``configs/reduce.py``).

The JAX side is ``LM(cfg, tp=..., remat=False, compute_dtype=float32)``;
its parameter tree is carried into the port by
``convert.lm_params_from_numpy``.  Inputs (tokens and ``frames``) come
from seeded numpy generators.

Tolerances, with their reasons: hidden states, logits, caches and the
loss rtol 1e-4, atol 1e-4 of the compared tensor's largest magnitude
(at least 1e-4), as ``tests/test_torch_lm.py`` (XLA and torch sum the
float32 products in another order); greedy tokens equal, except where
the JAX logits of the two picks lie within ``TIE_F32`` (1e-4).

The reference decodes without the encoder (ROADMAP.md, R6): ``generate``
zeroes the cross-attention cache and never fills it, so the port's
decode does the same, and ``test_r6_generate_ignores_the_encoder`` pins
it on both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.reduce import reduced as jreduced
from repro.models import common as jcommon
from repro.models.model import LM as JLM
from repro.serve.decode import generate as jgenerate
from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import common
from repro_torch.models.model import LM
from repro_torch.serve.decode import generate

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

TOL = 1e-4
TIE_F32 = 1e-4
ARCH = "seamless-m4t-large-v2"


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


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for t in tree for x in _leaves(t)]


def _pair(tp=1):
    jlm = JLM(jreduced(jget_config(ARCH)), tp=tp, remat=False,
              compute_dtype=jnp.float32)
    params = jlm.init(jax.random.key(0))
    lm = LM(reduced(get_config(ARCH)), tp=tp, device="cpu",
            dtype=torch.float32)
    lm_params_from_numpy(jax.tree.map(np.asarray, params), lm)
    return lm.cfg, jlm, params, lm


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX LM, its float32 params, the port's float32 LM holding
    them) at the reduced config."""
    return _pair()


def _batch(cfg, seed, b=2, s=20):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s), np.int32),
            "frames": rng.normal(0, 1, (b, s // cfg.enc_len_ratio,
                                        cfg.d_model)).astype(np.float32),
            "targets": rng.integers(0, cfg.vocab_size, (b, s), np.int32)}


@pytest.mark.parametrize("tp", [1, 3])
def test_param_defs_equal_jax(tp):
    """``encoder`` (stacked), ``enc_norm`` (unstacked) and ``layers``
    with ``ln3`` and ``xattn``, leaf for leaf and in flatten order; one
    parameter per stacked index; vectors float32, matrices in the
    compute dtype."""
    cfg = reduced(get_config(ARCH))
    jlm = JLM(jreduced(jget_config(ARCH)), tp=tp, remat=False)
    lm = LM(cfg, tp=tp, device="meta", dtype=torch.bfloat16)
    flat = common.flatten_defs(lm.param_defs())
    jflat = jax.tree.flatten_with_path(
        jlm.param_defs(), is_leaf=lambda d: isinstance(d, jcommon.ParamDef))[0]
    assert [(p, tuple(d)) for p, d in flat] == \
        [(tuple(k.key for k in path), tuple(d)) for path, d in jflat]
    for path, d in flat:
        stacked = sum(a == "layers" for a in d.axes)
        assert len(lm.leaf_parameters(path)) == \
            int(np.prod(d.shape[:stacked])), path
        assert lm.leaf_parameters(path)[0].dtype == (
            torch.float32 if len(d.shape) - stacked <= 1
            else torch.bfloat16), path


def test_param_storage_flattens_in_jax_order(pair):
    cfg, jlm, params, lm = pair
    jleaves = jax.tree.leaves(params)
    got = _leaves(lm.params)
    assert len(got) == len(jleaves)
    for a, b in zip(got, jleaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        lm.layers[1].xattn["wk"].numpy(),
        np.asarray(params["layers"]["xattn"]["wk"][1]))
    assert lm.enc_norm.data_ptr() == lm.params["enc_norm"].data_ptr()


def test_full_width_param_count_equals_jax():
    lm = LM(get_config(ARCH), device="meta", dtype=torch.bfloat16)
    jdefs = JLM(jget_config(ARCH), tp=1, remat=False).param_defs()
    jn = sum(int(np.prod(d.shape)) for d in jax.tree.leaves(
        jdefs, is_leaf=lambda d: isinstance(d, jcommon.ParamDef)))
    assert common.count_params(lm) == jn


def test_encoder_cross_attention_and_forward_match_jax(pair):
    """The encoder output (bidirectional, then ``enc_norm``), one
    decoder layer's cross-attention (no RoPE, keys and values from the
    encoder) and the hidden states of the whole forward with
    ``frames``."""
    cfg, jlm, params, lm = pair
    b = _batch(cfg, 1)
    jframes, frames = jnp.asarray(b["frames"]), _t(b["frames"])

    def jencode(p, f):
        enc, _ = jax.lax.scan(jlm._encdec_enc_body(), f, p["encoder"])
        return jcommon.rms_norm(enc, p["enc_norm"], cfg.norm_eps)
    jenc = jax.jit(jencode)(params, jframes)
    enc = lm._encode(frames)
    _close(enc, jenc)
    x = np.random.default_rng(2).normal(0, 1, (2, 20, cfg.d_model)) \
        .astype(np.float32)
    lp1 = jax.tree.map(lambda t: t[1], params["layers"])
    jy, (jk, jv) = jlm._cross_attn(lp1["xattn"], jnp.asarray(x), jenc)
    y, (k, v) = lm._cross_attn(lm.layers[1].xattn, _t(x), enc)
    _close(y, jy)
    _close(k, jk)
    _close(v, jv)
    jh, _ = jax.jit(lambda p, t, f: jlm._forward(p, t, frames=f))(
        params, jnp.asarray(b["tokens"]), jframes)
    h, _ = lm._forward(_t(b["tokens"]), frames=frames)
    _close(h, jh)


def test_prefill_matches_jax(pair):
    """Logits, the greedy token and the prefill cache ``((k, v), (xk,
    xv))`` stacked over the decoder layers."""
    cfg, jlm, params, lm = pair
    b = _batch(cfg, 3)
    jb = {k: jnp.asarray(b[k]) for k in ("tokens", "frames")}
    jtok, jcache = jax.jit(jlm.prefill)(params, jb)
    tok, cache = lm.prefill({k: _t(b[k]) for k in ("tokens", "frames")})
    jh, _ = jax.jit(lambda p, t, f: jlm._forward(p, t, frames=f))(
        params, jb["tokens"], jb["frames"])
    _tokens_agree(tok.numpy(), jtok, jlm._logits(params, jh[:, -1:])[:, 0])
    assert jax.tree.structure(jcache) == jax.tree.structure(
        jax.tree.map(lambda t: 0, cache))
    for got, want in zip(_leaves(cache), jax.tree.leaves(jcache)):
        assert tuple(got.shape) == want.shape
        _close(got, want)


def test_init_cache_and_decode_match_jax(pair):
    """``init_cache``: ``k`` / ``v`` of ``len`` slots and ``xk`` / ``xv``
    of max(1, len // enc_len_ratio), zeros, JAX's shapes and dtype; 20
    decode steps from it agree in tokens and caches (``xk`` / ``xv``
    stay zero on both)."""
    cfg, jlm, params, lm = pair
    s = 20
    cache, jcache = lm.init_cache(2, s), jlm.init_cache(2, s)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jcache) == \
        jax.tree.map(lambda t: (tuple(t.shape), "float32"), cache)
    assert cache["xk"].shape[2] == max(1, s // cfg.enc_len_ratio)
    toks = _batch(cfg, 4)["tokens"]
    step = jax.jit(jlm.decode_step)
    for pos in range(s):
        jtok, jcache = step(params, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                            jnp.int32(pos))
        tok, cache = lm.decode_step(cache, _t(toks[:, pos:pos + 1]), pos)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        for got, want in zip(_leaves(cache), jax.tree.leaves(jcache)):
            _close(got, want)
    assert not cache["xk"].any() and not cache["xv"].any()


def test_generate_and_loss_match_jax(pair):
    """``generate`` gives JAX's tokens; ``loss`` with ``frames`` is JAX's
    in value."""
    cfg, jlm, params, lm = pair
    b = _batch(cfg, 5, s=12)
    want = jax.jit(lambda p, t: jgenerate(jlm, p, t, max_new=8))(
        params, jnp.asarray(b["tokens"]))
    got = generate(lm, _t(b["tokens"]), max_new=8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jloss, jm = jax.jit(jlm.loss)(params, {k: jnp.asarray(v)
                                           for k, v in b.items()})
    loss, m = lm.loss({k: _t(v) for k, v in b.items()})
    _close(loss, jloss)
    _close(m["acc"], jm["acc"])


def test_padded_heads_match_jax():
    """A tree the JAX ``LM`` made at tp=3 (MHA 4 heads padded to 6)
    loads and runs the same forward, with ``frames``."""
    cfg, jlm, params, lm = _pair(tp=3)
    assert lm.attn_cfg.hq == 6
    b = _batch(cfg, 6)
    jh, _ = jax.jit(lambda p, t, f: jlm._forward(p, t, frames=f))(
        params, jnp.asarray(b["tokens"]), jnp.asarray(b["frames"]))
    _close(lm._forward(_t(b["tokens"]), frames=_t(b["frames"]))[0], jh)


def test_r6_generate_ignores_the_encoder(pair):
    """ROADMAP.md, R6, pinned on both packages: prefill depends on
    ``frames`` (two draws give different logits), but ``generate`` takes
    none and its decode attends to a zero cross-attention cache, so its
    tokens stay the same when every cross-attention weight is replaced
    (the encoder's path is dead in serving)."""
    cfg, jlm, params, lm = pair
    b1, b2 = _batch(cfg, 7), _batch(cfg, 8)
    toks = b1["tokens"]
    h1, _ = lm._forward(_t(toks), frames=_t(b1["frames"]))
    h2, _ = lm._forward(_t(toks), frames=_t(b2["frames"]))
    jfwd = jax.jit(lambda p, t, f: jlm._forward(p, t, frames=f)[0])
    jh1 = jfwd(params, jnp.asarray(toks), jnp.asarray(b1["frames"]))
    jh2 = jfwd(params, jnp.asarray(toks), jnp.asarray(b2["frames"]))
    assert float((h1 - h2).abs().max()) > 1e-2
    assert float(jnp.abs(jh1 - jh2).max()) > 1e-2

    rng = np.random.default_rng(9)
    other = jax.tree.map(np.asarray, params)
    other["layers"]["xattn"] = {
        k: rng.normal(0, 1, v.shape).astype(np.float32)
        for k, v in other["layers"]["xattn"].items()}
    lm2 = LM(cfg, device="cpu", dtype=torch.float32)
    lm_params_from_numpy(other, lm2)
    prompt = toks[:, :10]
    gen = jax.jit(lambda p, t: jgenerate(jlm, p, t, max_new=6))
    want = np.asarray(gen(params, jnp.asarray(prompt)))
    np.testing.assert_array_equal(
        np.asarray(gen(jax.tree.map(jnp.asarray, other),
                       jnp.asarray(prompt))), want)
    np.testing.assert_array_equal(generate(lm, _t(prompt), max_new=6).numpy(),
                                  want)
    np.testing.assert_array_equal(
        generate(lm2, _t(prompt), max_new=6).numpy(), want)


def test_serve_launcher_runs_encdec_on_cpu():
    from repro_torch.launch.serve import run
    res = run(ARCH, batch=2, prompt_len=5, max_new=3, device="cpu")
    out = res["out"]
    assert tuple(out.shape) == (2, 3) and int(out.max()) < 512
    assert res["line"].startswith(res["cfg"].name + ": (2, 3) in ")


def test_serve_launcher_names_weights_that_do_not_fit(monkeypatch):
    """A build that runs out of device memory raises
    ``torch.OutOfMemoryError`` naming the config's weight bytes and the
    ``--layers`` cut (simulated at reduced width: the CPU would not
    refuse)."""
    from repro_torch.launch import serve
    from repro_torch.models import model

    def oom(self, generator):
        raise torch.OutOfMemoryError("CUDA out of memory")
    monkeypatch.setattr(model.LM, "init", oom)
    nbytes = sum(p.numel() * p.element_size() for p in LM(
        reduced(get_config(ARCH)), device="meta").parameters())
    with pytest.raises(torch.OutOfMemoryError,
                       match=f"seamless-m4t-large-v2-smoke at 2 layers "
                             f"holds {nbytes:,} bytes of bfloat16 weights, "
                             f"more than cpu can hold: cut its depth with "
                             f"--layers"):
        serve.main(["--arch", ARCH, "--device", "cpu"])
