"""Port parity for the ``moe`` family (``models/moe`` routed experts,
``models/mla`` and the llama4-scout / deepseek-v2 branches of ``LM``)
against the JAX package on the same inputs, on the CPU, in float32 at
the reduced configs (``configs/reduce.py``).

The JAX side is ``LM(cfg, tp=..., remat=False, compute_dtype=float32)``;
its parameter tree is carried into the port by
``convert.lm_params_from_numpy``.  Inputs come from seeded numpy
generators.

Tolerances, with their reasons:

- every float32 tensor (the MoE and MLA blocks, hidden states, logits,
  caches, the loss): rtol 1e-4, atol 1e-4 of the compared tensor's
  largest magnitude (at least 1e-4), as ``tests/test_torch_lm.py`` —
  XLA and torch sum the float32 products in another order;
- greedy tokens: equal, except where the JAX logits of the two picks
  lie within ``TIE_F32`` (1e-4);
- routing: a test whose expert choice could turn on rounding first
  asserts, as a stated precondition, that every token's k-th and
  (k+1)-th gates lie more than ``GATE_GAP`` (1e-5) apart; the inputs
  are not re-seeded to pass it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.reduce import reduced as jreduced
from repro.models import common as jcommon
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models.model import LM as JLM
from repro.serve.decode import generate as jgenerate
from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import common
from repro_torch.models import mla
from repro_torch.models import moe
from repro_torch.models.model import LM
from repro_torch.serve.decode import generate

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

TOL = 1e-4
TIE_F32 = 1e-4
GATE_GAP = 1e-5
ARCHS = ["llama4-scout-17b-a16e", "deepseek-v2-236b"]


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


def _tree(defs_fn, cfg, seed):
    return jax.tree.map(np.asarray, jcommon.init_params(
        defs_fn(cfg), jax.random.key(seed)))


def _gates_apart(gates: np.ndarray, k: int) -> None:
    """The stated precondition of a routing comparison: each token's
    k-th and (k+1)-th largest gates lie more than GATE_GAP apart."""
    s = -np.sort(-np.asarray(gates, np.float32), axis=-1)
    if s.shape[-1] > k:
        gap = (s[..., k - 1] - s[..., k]).min()
        assert gap > GATE_GAP, f"a top-k near-tie ({gap:.2e}) in the inputs"


# -- routed experts ----------------------------------------------------------

# (d_model, n_experts, top_k, d_ff, n_shared, shared_d_ff): the reduced
# llama4 and deepseek MoE blocks, then the published E and k at d_model 64
MOE_CASES = {
    "llama4-reduced": (64, 4, 1, 128, 1, 128),
    "deepseek-reduced": (64, 8, 2, 64, 2, 128),
    "llama4-E16-k1": (64, 16, 1, 32, 1, 32),
    "deepseek-E160-k6": (64, 160, 6, 16, 2, 32),
}


def _moe(case, seed, scale=1.0):
    args = MOE_CASES[case]
    c, jc = moe.MoECfg(*args), jmoe.MoECfg(*args)
    p = _tree(jmoe.moe_defs, jc, seed)
    p["router"] = (p["router"] * scale).astype(np.float32)
    return c, jc, p


def _tp(p):
    return {k: _tp(v) if isinstance(v, dict) else _t(v) for k, v in p.items()}


def _jp(p):
    return {k: _jp(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in p.items()}


def _jmoe(jc, p, x) -> np.ndarray:
    return np.asarray(jax.jit(lambda p, x: jmoe.moe_apply(jc, p, x))(
        _jp(p), jnp.asarray(x)))


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_drops_tokens_and_matches_jax(case):
    """At (3, 12) tokens that share one direction (so they favour the
    same experts; router scaled by 8) the capacity int(1.25·T·k/E) drops
    tokens: the drop count is asserted > 0, and the routing, the output
    and the drops are JAX's."""
    c, jc, p = _moe(case, 1, scale=8.0)
    rng = np.random.default_rng(2)
    x = (rng.normal(0, 1, (64,)) + rng.normal(0, 1, (3, 12, 64))) \
        .astype(np.float32)
    xt = x.reshape(-1, 64)
    jgates = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(p["router"]), -1)
    _gates_apart(jgates, c.top_k)
    r = moe.moe_route(c, _t(p["router"]), _t(xt))
    _close(r.gates, jgates)
    jw, ji = jax.lax.top_k(jgates, c.top_k)
    np.testing.assert_array_equal(r.top_i.numpy(), np.asarray(ji))
    _close(r.top_w, np.asarray(jw) / np.asarray(jw).sum(-1, keepdims=True))
    dropped = int((~r.keep).sum())
    assert r.cap == int(max(1, 1.25 * 36 * c.top_k / c.n_experts))
    assert dropped > 0, "the capacity must drop tokens at this shape"
    _close(moe.moe_apply(c, _tp(p), _t(x)), _jmoe(jc, p, x))


@pytest.mark.parametrize("case", ["llama4-reduced", "deepseek-reduced",
                                  "deepseek-E160-k6"])
def test_moe_zero_router_ties_pick_lowest_experts(case):
    """A zero router makes every gate 1/E: ``jax.lax.top_k`` picks
    experts 0..k-1 (the lower index on a tie), and so must the port."""
    c, jc, p = _moe(case, 3, scale=0.0)
    x = np.random.default_rng(4).normal(0, 1, (2, 5, 64)).astype(np.float32)
    r = moe.moe_route(c, _t(p["router"]), _t(x.reshape(-1, 64)))
    np.testing.assert_array_equal(
        r.top_i.numpy(), np.broadcast_to(np.arange(c.top_k), (10, c.top_k)))
    _close(moe.moe_apply(c, _tp(p), _t(x)), _jmoe(jc, p, x))


@pytest.mark.parametrize("case", ["llama4-E16-k1", "deepseek-E160-k6"])
def test_r7_decode_drops_tokens_by_batch_position(case):
    """ROADMAP.md, R7, pinned on both packages: a decode step at B=8
    (S=1) gets capacity 1 at the configs' E and k, so of 8 identical
    rows only row 0 keeps its experts: it equals the row run alone, and
    rows 1-7 (the shared experts only) differ from it."""
    c, jc, p = _moe(case, 5)
    row = np.random.default_rng(6).normal(0, 1, (1, 1, 64)) \
        .astype(np.float32)
    _gates_apart(jax.nn.softmax(jnp.asarray(row[0]) @ p["router"], -1),
                 c.top_k)
    x = np.repeat(row, 8, axis=0)
    got = moe.moe_apply(c, _tp(p), _t(x))
    want = _jmoe(jc, p, x)
    _close(got, want)
    for out in (got.numpy(), want):
        alone = _jmoe(jc, p, row)
        np.testing.assert_allclose(out[0], alone[0], rtol=TOL, atol=TOL)
        assert (np.abs(out[1:] - out[:1]).max(axis=(1, 2)) > 1e-3).all()
        np.testing.assert_allclose(out[1:], np.broadcast_to(out[1:2],
                                                            out[1:].shape))


# -- MLA ---------------------------------------------------------------------


def _mla(tp, seed=7):
    cfg = reduced(get_config("deepseek-v2-236b"))
    kw = dict(kv_lora=cfg.kv_lora, q_lora=cfg.q_lora,
              rope_head_dim=cfg.rope_head_dim,
              nope_head_dim=cfg.nope_head_dim, v_head_dim=cfg.v_head_dim,
              rope_theta=cfg.rope_theta, tp=tp)
    c = mla.MLACfg(cfg.d_model, cfg.n_heads, **kw)
    jc = jmla.MLACfg(cfg.d_model, cfg.n_heads, **kw)
    p = _tree(jmla.mla_defs, jc, seed)
    rng = np.random.default_rng(seed)
    for k in ("q_norm", "kv_norm"):      # off their ones, so they show
        p[k] = (p[k] + rng.normal(0, 0.3, p[k].shape)).astype(np.float32)
    return c, jc, p


@pytest.mark.parametrize("tp", [1, 3])
def test_mla_apply_matches_jax(tp):
    """Prefill output and latent cache; tp=3 pads 4 query heads to 6
    and masks two."""
    c, jc, p = _mla(tp)
    assert c.hq == jc.hq == (4 if tp == 1 else 6)
    x = np.random.default_rng(8).normal(0, 1, (2, 11, 64)).astype(np.float32)
    y, (ckv, kpe) = mla.mla_apply(c, _tp(p), _t(x), q_offset=3)
    jy, (jckv, jkpe) = jax.jit(lambda p, x: jmla.mla_apply(
        jc, p, x, q_offset=3))(_jp(p), jnp.asarray(x))
    _close(y, jy)
    _close(ckv, jckv)
    _close(kpe, jkpe)


def test_mla_apply_blockwise_branch(monkeypatch):
    """Past the threshold both packages take the online-softmax path
    (lowered to 8 on the port's side; the JAX side compared at its own
    dense path, the same function)."""
    c, jc, p = _mla(1)
    monkeypatch.setattr(mla, "BLOCKWISE_THRESHOLD", 8)
    calls = []
    monkeypatch.setattr(mla, "blockwise_attention",
                        lambda *a, **k: calls.append(1) or
                        common.blockwise_attention(*a, **k))
    x = np.random.default_rng(9).normal(0, 1, (2, 11, 64)).astype(np.float32)
    y, _ = mla.mla_apply(c, _tp(p), _t(x))
    jy, _ = jax.jit(lambda p, x: jmla.mla_apply(jc, p, x))(
        _jp(p), jnp.asarray(x))
    assert calls == [1]
    _close(y, jy)


@pytest.mark.parametrize("tp", [1, 3])
def test_mla_decode_both_forms_match_jax(tp):
    """Step by step from a zero latent cache of 10 slots over 12
    positions (the last two past it: the write clamps to the last slot,
    as ``dynamic_update_slice``): the absorbed and the explicit forms
    against each other and against JAX's, outputs and caches."""
    c, jc, p = _mla(tp, seed=10)
    tp_, jp = _tp(p), _jp(p)
    xs = np.random.default_rng(11).normal(0, 1, (12, 2, 1, 64)) \
        .astype(np.float32)
    caches = {form: (torch.zeros(2, 10, c.kv_lora),
                     torch.zeros(2, 10, c.rope_head_dim))
              for form in (True, False)}
    jcaches = {form: (jnp.zeros((2, 10, c.kv_lora)),
                      jnp.zeros((2, 10, c.rope_head_dim)))
               for form in (True, False)}
    steps = {form: jax.jit(lambda p, x, a, b, pos, form=form:
                           jmla.mla_decode(jc, p, x, a, b, pos,
                                           absorbed=form))
             for form in (True, False)}
    for pos in range(12):
        ys = {}
        for form in (True, False):
            y, ckv, kpe = mla.mla_decode(c, tp_, _t(xs[pos]), *caches[form],
                                         pos, absorbed=form)
            jy, jckv, jkpe = steps[form](jp, jnp.asarray(xs[pos]),
                                         *jcaches[form], jnp.int32(pos))
            jcaches[form] = (jckv, jkpe)
            _close(y, jy)
            _close(ckv, jckv)
            _close(kpe, jkpe)
            ys[form] = y
        _close(ys[True], ys[False].numpy())


# -- the LM ------------------------------------------------------------------


def _pair(arch, tp=1, **kw):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **kw)
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    jlm = JLM(jcfg, tp=tp, remat=False, compute_dtype=jnp.float32)
    params = jlm.init(jax.random.key(0))
    lm = LM(cfg, tp=tp, device="cpu", dtype=torch.float32)
    lm_params_from_numpy(jax.tree.map(np.asarray, params), lm)
    return cfg, jlm, params, lm


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(cfg, JAX LM, its float32 params, the port's float32 LM holding
    them) at the reduced config (llama4: chunk 16)."""
    return _pair(request.param)


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for t in tree for x in _leaves(t)]


@pytest.mark.parametrize("tp", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_equal_jax(arch, tp):
    """The parameter tree (llama4's ``blocks/local`` stacked twice and
    ``blocks/global`` once; deepseek's unstacked ``first``), leaf for
    leaf and in flatten order, is JAX's; each leaf is viewed by one
    parameter per stacked index; vectors are stored float32, matrices
    in the compute dtype."""
    cfg = reduced(get_config(arch))
    jlm = JLM(jreduced(jget_config(arch)), tp=tp, remat=False)
    lm = LM(cfg, tp=tp, device="meta", dtype=torch.bfloat16)
    flat = common.flatten_defs(lm.param_defs())
    jflat = jax.tree.flatten_with_path(
        jlm.param_defs(), is_leaf=lambda d: isinstance(d, jcommon.ParamDef))[0]
    assert [(p, tuple(d)) for p, d in flat] == \
        [(tuple(k.key for k in path), tuple(d)) for path, d in jflat]
    for path, d in flat:
        stacked = sum(a == "layers" for a in d.axes)
        leaf = lm.params
        for k in path:
            leaf = leaf[k]
        assert leaf.dtype == (torch.float32 if len(d.shape) - stacked <= 1
                              else torch.bfloat16), path
        views = lm.leaf_parameters(path)
        assert len(views) == int(np.prod(d.shape[:stacked])), path
        assert all(tuple(v.shape) == d.shape[stacked:] for v in views), path


def test_param_storage_and_views(pair):
    """``lm.params`` flattens in JAX's order (the order checkpoints and
    ``lm_params_from_numpy`` use) and the modules view it: llama4's
    ``blocks[s].local[j]`` / ``blocks[s]["global"]``, deepseek's
    ``first`` and ``layers[i].moe["shared"]``."""
    cfg, jlm, params, lm = pair
    jleaves = jax.tree.leaves(params)
    got = _leaves(lm.params)
    assert len(got) == len(jleaves)
    for a, b in zip(got, jleaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if cfg.use_mla:
        assert lm.first.attn["w_dq"].data_ptr() == \
            lm.params["first"]["attn"]["w_dq"].data_ptr()
        w = lm.layers[1].moe["shared"]["w1"]
        np.testing.assert_array_equal(
            w.numpy(), np.asarray(params["layers"]["moe"]["shared"]["w1"][1]))
    else:
        np.testing.assert_array_equal(
            lm.blocks[1].local[0].moe["w2"].numpy(),
            np.asarray(params["blocks"]["local"]["moe"]["w2"][1, 0]))
        np.testing.assert_array_equal(
            lm.blocks[1]["global"].attn["wq"].numpy(),
            np.asarray(params["blocks"]["global"]["attn"]["wq"][1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_count_equals_jax(arch):
    """At the published widths and depths, counted from the definitions
    (the port's tree built on the meta device)."""
    lm = LM(get_config(arch), device="meta", dtype=torch.bfloat16)
    jdefs = JLM(jget_config(arch), tp=1, remat=False).param_defs()
    jn = sum(int(np.prod(d.shape)) for d in jax.tree.leaves(
        jdefs, is_leaf=lambda d: isinstance(d, jcommon.ParamDef)))
    assert common.count_params(lm) == jn


def test_prefill_matches_jax(pair):
    """Hidden states, the last logits, the greedy token and the prefill
    cache (llama4: ``((k, v) per superblock and local layer, (k, v) per
    global layer)``; deepseek: ``((c_kv, k_pe) of the first layer, the
    others' stacked)``) at S = 21, past llama4's reduced chunk of 16."""
    cfg, jlm, params, lm = pair
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 21),
                                              np.int32)
    jh, _ = jax.jit(lambda p, t: jlm._forward(p, t))(params,
                                                      jnp.asarray(toks))
    h, _ = lm._forward(_t(toks))
    _close(h, jh)
    jlogits = jlm._logits(params, jh[:, -1:])[:, 0]
    _close(lm._logits(h[:, -1:])[:, 0], jlogits)
    jtok, jcache = jax.jit(jlm.prefill)(params, {"tokens": jnp.asarray(toks)})
    tok, cache = lm.prefill({"tokens": _t(toks)})
    assert tok.dtype == torch.int32
    _tokens_agree(tok.numpy(), jtok, jlogits)
    assert jax.tree.structure(jcache) == jax.tree.structure(
        jax.tree.map(lambda t: 0, cache))
    for got, want in zip(_leaves(cache), jax.tree.leaves(jcache)):
        assert tuple(got.shape) == want.shape
        _close(got, want)


def test_init_cache_and_decode_match_jax(pair):
    """``init_cache`` has JAX's structure, shapes and dtype (llama4's
    local layers keep min(chunk, len) = 16 ring slots; deepseek's
    latents, ``rest`` sized n_layers − 1); 24 decode steps from it agree
    in tokens and caches (llama4's ring wraps at position 16)."""
    cfg, jlm, params, lm = pair
    s = 24
    cache, jcache = lm.init_cache(2, s), jlm.init_cache(2, s)
    jshape = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jcache)
    assert jshape == jax.tree.map(lambda t: (tuple(t.shape), "float32"),
                                  cache)
    assert not any(t.any() for t in _leaves(cache))
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, s),
                                              np.int32)
    step = jax.jit(jlm.decode_step)
    for pos in range(s):
        tok_in = toks[:, pos:pos + 1]
        jtok, jcache = step(params, jcache, jnp.asarray(tok_in),
                            jnp.int32(pos))
        tok, cache = lm.decode_step(cache, _t(tok_in), pos)
        if not (tok.numpy() == np.asarray(jtok)).all():
            raise AssertionError(f"position {pos}: {tok} vs {jtok}")
        for got, want in zip(_leaves(cache), jax.tree.leaves(jcache)):
            _close(got, want)


def test_generate_and_loss_match_jax(pair):
    """``generate`` (the cache built by decode-stepping the prompt)
    gives JAX's tokens; ``loss`` is JAX's in value."""
    cfg, jlm, params, lm = pair
    rng = np.random.default_rng(14)
    toks = rng.integers(0, cfg.vocab_size, (2, 12), np.int32)
    want = jax.jit(lambda p, t: jgenerate(jlm, p, t, max_new=8))(
        params, jnp.asarray(toks))
    got = generate(lm, _t(toks), max_new=8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    batch = {"tokens": toks,
             "targets": rng.integers(0, cfg.vocab_size, (2, 12), np.int32)}
    jloss, jm = jlm.loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, m = lm.loss({k: _t(v) for k, v in batch.items()})
    _close(loss, jloss)
    _close(m["acc"], jm["acc"])


def test_deepseek_padded_heads_lm_matches_jax():
    """A deepseek tree the JAX ``LM`` made at tp=3 (4 query heads padded
    to 6) loads, prefills and generates the same."""
    cfg, jlm, params, lm = _pair("deepseek-v2-236b", tp=3)
    assert lm.mla_cfg.hq == 6 and lm.first.attn["w_uq"].shape[1] == 6
    toks = np.random.default_rng(15).integers(0, cfg.vocab_size, (2, 10),
                                              np.int32)
    jh, _ = jax.jit(lambda p, t: jlm._forward(p, t))(params,
                                                      jnp.asarray(toks))
    _close(lm._forward(_t(toks))[0], jh)
    want = jax.jit(lambda p, t: jgenerate(jlm, p, t, max_new=4))(
        params, jnp.asarray(toks))
    np.testing.assert_array_equal(generate(lm, _t(toks), max_new=4).numpy(),
                                  np.asarray(want))


def test_r8_deepseek_rest_cache_sized_by_n_layers():
    """ROADMAP.md, R8, recorded with no behaviour change: ``init_cache``
    sizes deepseek's ``rest`` by n_layers − 1 on both packages, where the
    layer stack holds n_layers − first_dense (equal for every shipped
    config, first_dense = 1)."""
    for cfg, jcfg in ((reduced(get_config("deepseek-v2-236b")),
                       jreduced(jget_config("deepseek-v2-236b"))),
                      (get_config("deepseek-v2-236b"),
                       jget_config("deepseek-v2-236b"))):
        assert cfg.first_dense == 1
        lm = LM(cfg, device="meta")
        jlm = JLM(jcfg, tp=1, remat=False)
        rest = lm.init_cache(1, 4)["rest"]["ckv"].shape[0]
        assert rest == jax.eval_shape(lambda: jlm.init_cache(1, 4))[
            "rest"]["ckv"].shape[0] == cfg.n_layers - 1
        assert len(lm.layers) == cfg.n_layers - cfg.first_dense


def test_llama4_depth_must_keep_superblocks():
    """The serving launcher cuts depth in whole superblocks."""
    from repro_torch.launch.serve import run
    with pytest.raises(ValueError, match="multiple of its superblock of 2"):
        run("llama4-scout-17b-a16e", layers=3, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_moe_on_cpu(arch):
    """``launch.serve.run`` serves the family at reduced width (depth
    cut to one superblock / the first layer and one MoE layer)."""
    from repro_torch.launch.serve import run
    layers = 2
    res = run(arch, batch=2, prompt_len=5, max_new=3, layers=layers,
              device="cpu")
    assert res["cfg"].n_layers == layers
    out = res["out"]
    assert tuple(out.shape) == (2, 3) and int(out.max()) < 512
    assert res["line"].startswith(res["cfg"].name + ": (2, 3) in ")
