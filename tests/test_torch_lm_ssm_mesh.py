"""Port parity for the ``ssm`` and ``hybrid`` families on a device mesh
(``models/sharded.py``'s mamba unit and zamba2's shared block), against
the JAX package on the CPU.

The JAX side is ``LM(cfg, tp=1, remat=False, compute_dtype=float32)``
unsharded, at the reduced configs (``configs/reduce.py``); its tree is
carried into a sharded port ``LM`` by ``convert.lm_params_from_numpy``.
At the reduced widths the JAX trees at ``tp`` 1, 2 and 4 are one tree
(zamba2's 4 query and 4 KV heads need no padding; asserted leaf by
leaf), so one JAX model serves every mesh.  The port's meshes list the
CPU four times (``[cpu] * 4``): (2, 2), (1, 4) and (4, 1).  Inputs and
random decode caches come from seeded numpy generators.

The cases the mesh must get right, each asserted as a precondition from
the shard shapes and specs, not assumed:

- zamba2's ``in_proj`` column blocks straddle the z | xBC | dt split
  (at tp 2 member 0 holds z and the first xBC channels), so the members
  exchange the product's blocks;
- mamba2-130m replicates ``ssm_inner`` (its ``rules_overrides``) while
  its SSM state's spec splits ``P`` over ``model``;
- a batch of 2 equal to a stacking depth: the JAX rule's ``shp.index``
  shards a stacking axis of every state and cache leaf, which the
  executor regathers into its working layout for the step;
- a batch of 1 with a 1,024-position cache: zamba2's shared block's
  cache splits its length over ``data`` (sequence-parallel decode).

Tolerances, with their reasons (``tests/test_torch_lm_moe_mesh.py``'s):

- float32 logits, decode caches (conv, SSM, k / v) and the loss: rtol
  1e-4 and an absolute 1e-4 of the compared tensor's largest magnitude
  (at least 1e-4) (XLA and torch sum float32 products in another order;
  the mesh adds the partial sums over ``model`` and the norm's sum of
  squares over the ``P`` slices in member order);
- greedy tokens: equal, except where the JAX logits of the two picks lie
  within ``TIE_F32`` (1e-4) of each other;
- stored bytes against the dry-run: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.reduce import reduced as jreduced
from repro.models import mamba2 as jmamba
from repro.models.model import LM as JLM
from repro_torch import tree as ttree
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.configs.reduce import reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed.sharding import Mesh, ShardedTensor
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import mesh_from_devices
from repro_torch.models.model import LM
from repro_torch.models.sharded import units
from repro_torch.train.step import (TrainHParams, init_train_state,
                                    make_train_step)

# one xdist worker per core runs these files beside the JAX suite
torch.set_num_threads(2)

ARCHS = ["mamba2-130m", "zamba2-2.7b"]
MESH_DIMS = [(2, 2), (1, 4), (4, 1)]
TOL = 1e-4
TIE_F32 = 1e-4
CPU4 = [torch.device("cpu")] * 4


def _close(got, want):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=TOL,
        atol=TOL * max(1.0, float(np.abs(want).max(initial=0.0))))


def _tokens_agree(got, want, logits):
    got, want = np.asarray(got), np.asarray(want)
    logits = np.asarray(logits, dtype=np.float32)
    rows = np.arange(len(want))
    gap = np.abs(logits[rows, got] - logits[rows, want])
    assert ((got == want) | (gap <= TIE_F32)).all(), (got, want, gap)


def _jax(arch):
    jlm = JLM(jreduced(jget_config(arch)), tp=1, remat=False,
              compute_dtype=jnp.float32)
    params = jlm.init(jax.random.key(7))
    return jlm, params, jax.tree.map(np.asarray, params)


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


def _mesh_lm(arch, dims, tree, dtype=torch.float32):
    data, model = dims
    mesh = mesh_from_devices(CPU4, model=model)
    assert mesh.dims == dims
    lm = LM(reduced(get_config(arch)), tp=model, mesh=mesh, dtype=dtype)
    for path, st in _flat(lm.params):     # one tree serves every tp
        assert st.shape == np.shape(_get(tree, path)), path
    lm_params_from_numpy(tree, lm)
    return lm


def _gathered(cache):
    return [t.gather().numpy() for t in ttree.leaves(cache)]


# -- the LM on the mesh against JAX -------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """The JAX LM's float32 outputs on one batch: every position's
    logits, the prefill token and cache, 4 decode steps from a cache of
    12 (tokens and caches) and the loss."""
    arch = request.param
    jlm, params, tree = _jax(arch)
    cfg = jlm.cfg
    rng = np.random.default_rng(1 + ARCHS.index(arch))
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 8), np.int32)
             for k in ("tokens", "targets")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    h, _ = jax.jit(lambda p, t: jlm._forward(p, t))(params, jb["tokens"])
    logits = np.asarray(jlm._logits(params, h))
    jtok, jcache = jax.jit(jlm.prefill)(params, {"tokens": jb["tokens"]})
    step = jax.jit(jlm.decode_step)
    dcache, steps = jlm.init_cache(4, 12), []
    for pos in range(4):
        t, dcache = step(params, dcache, jb["tokens"][:, pos:pos + 1],
                         jnp.int32(pos))
        steps.append(np.asarray(t))
    loss, _ = jax.jit(jlm.loss)(params, jb)
    return {"arch": arch, "tree": tree, "batch": batch, "logits": logits,
            "tok": np.asarray(jtok),
            "prefill_cache": [np.asarray(x) for x in jax.tree.leaves(jcache)],
            "steps": steps,
            "decode_cache": [np.asarray(x) for x in jax.tree.leaves(dcache)],
            "loss": float(loss)}


@pytest.mark.parametrize("dims", MESH_DIMS, ids=lambda d: f"{d[0]}x{d[1]}")
def test_ssm_mesh_matches_jax(ref, dims):
    """Prefill logits, next token and cache (every conv / SSM state, and
    zamba2's shared-block k / v), 4 decode steps (tokens and the gathered
    cache) and the ``loss`` value on the CPU mesh, against the unsharded
    JAX LM on the same weights."""
    lm = _mesh_lm(ref["arch"], dims, ref["tree"])
    tb = {k: torch.as_tensor(v) for k, v in ref["batch"].items()}
    _close(lm._mesh_exec().logits({"tokens": tb["tokens"]}), ref["logits"])
    tok, cache = lm.prefill({"tokens": tb["tokens"]})
    _tokens_agree(tok, ref["tok"], ref["logits"][:, -1])
    assert all(isinstance(t, ShardedTensor) for t in ttree.leaves(cache))
    for got, want in zip(_gathered(cache), ref["prefill_cache"], strict=True):
        _close(got, want)
    pc = lm.init_cache(4, 12)
    assert all(isinstance(t, ShardedTensor) for t in ttree.leaves(pc))
    for pos, want in enumerate(ref["steps"]):
        nxt, pc = lm.decode_step(pc, tb["tokens"][:, pos:pos + 1], pos)
        np.testing.assert_array_equal(nxt.numpy(), want)
    for got, want in zip(_gathered(pc), ref["decode_cache"], strict=True):
        _close(got, want)
    loss, _ = lm.loss(tb)
    _close(loss, ref["loss"])


# -- the mamba unit's layout -------------------------------------------------------


def _random_cache(jlm, b, cache_len, seed):
    """A JAX decode cache of random entries, and its numpy leaves."""
    jcache = jlm.init_cache(b, cache_len)
    rng = np.random.default_rng(seed)
    filled = [rng.normal(0, 1, np.shape(x)).astype(np.float32)
              for x in jax.tree.leaves(jcache)]
    return jax.tree.unflatten(jax.tree.structure(jcache),
                              [jnp.asarray(x) for x in filled]), filled


def _run_steps(jlm, params, jcache, lm, pc, b, positions, seed):
    """Decode steps at ``positions`` on both, tokens compared bitwise;
    then every cache leaf within the tolerance."""
    toks = np.random.default_rng(seed).integers(
        0, lm.cfg.vocab_size, (len(positions), b, 1), np.int32)
    step = jax.jit(jlm.decode_step)
    for pos, tok in zip(positions, toks):
        want, jcache = step(params, jcache, jnp.asarray(tok), jnp.int32(pos))
        got, pc = lm.decode_step(pc, torch.as_tensor(tok), pos)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"position {pos}")
    for got, want in zip(_gathered(pc), jax.tree.leaves(jcache),
                         strict=True):
        _close(got, want)


@pytest.mark.parametrize("dims", [(2, 2), (1, 4)],
                         ids=lambda d: f"{d[0]}x{d[1]}")
def test_zamba2_in_proj_blocks_straddle_the_split(dims):
    """Precondition from the shard shapes: ``in_proj``'s column blocks
    cross the boundaries of z | xBC | dt (at tp 2 both members' blocks,
    at tp 4 the second's and the fourth's: no member can split its
    product locally), the SSM state splits ``P`` over ``model`` and
    ``out_proj``'s rows split in head-aligned blocks.  Then one mamba
    layer on the mesh, over the sequence and for a decode step from a
    random state, equals the JAX ``mamba_apply`` / ``mamba_decode``."""
    arch = "zamba2-2.7b"
    jlm, params, tree = _jax(arch)
    lm = _mesh_lm(arch, dims, tree)
    c, tp = lm.mamba_cfg, dims[1]
    in_proj = lm.params["blocks"]["mamba"]["in_proj"]
    width = in_proj.shards[0].shape[-1]
    assert width == c.d_in_proj // tp
    edges = {c.d_inner, c.d_inner + c.conv_dim}
    straddled = [k for k in range(tp)
                 if any(k * width < e < (k + 1) * width for e in edges)]
    assert straddled == ([0, 1] if tp == 2 else [1, 3]), (width, edges)
    assert lm.params["blocks"]["mamba"]["out_proj"].shards[0].shape[2] % \
        c.head_dim == 0
    pc = lm.init_cache(4, 12)
    assert pc["ssm"].shards[0].shape[-2] == c.head_dim // tp
    assert pc["ssm"].sharding.spec[4] == "model"
    ex = lm._mesh_exec()
    u = next(u for u in ex.units if u.kind == "mamba")
    p = jax.tree.map(lambda a: a[u.idx], tree["blocks"]["mamba"])
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (4, 6, c.d_model)).astype(np.float32)
    rows = ex._rows(4)
    got, states = ex._mamba(u, ex._split(torch.as_tensor(x), rows), 4)
    # the layer adds mamba(ln(x)) to x; the JAX block sees ln(x)
    ln = lm.gather_params()["blocks"]["ln"][u.idx].numpy()
    h = x * (1.0 / np.sqrt((x * x).mean(-1, keepdims=True) + c.norm_eps)) \
        * ln
    jy, (jconv, jssm) = jmamba.mamba_apply(
        jlm.mamba_cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(h))
    _close(ex._join(got, rows) - torch.as_tensor(x), jy)
    assert len(states[0][1].shape) == 4 and \
        states[0][1].shape[2] == c.head_dim // tp
    # the states' slices assembled in member order are JAX's
    layer_shape = pc["ssm"].shape[2:]
    mesh_ssm = ShardedTensor(lm.cache_sharding(layer_shape, 4, bdim=0),
                             layer_shape, [s[1] for s in states])
    _close(mesh_ssm.gather(), jssm)
    # one decode step from a random state, every member its P slice
    jconv0 = rng.normal(0, 1, np.shape(jconv)).astype(np.float32)
    jssm0 = rng.normal(0, 1, np.shape(jssm)).astype(np.float32)
    xt = x[:, :1]
    ht = h[:, :1]
    jy, jc1, js1 = jmamba.mamba_decode(
        jlm.mamba_cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(ht),
        jnp.asarray(jconv0), jnp.asarray(jssm0))
    for name, full in (("conv", jconv0), ("ssm", jssm0)):
        st = pc[name]
        whole = np.zeros(st.shape, np.float32)
        whole[u.cidx] = full
        st.copy_(torch.as_tensor(whole))
    work = ex._working(pc, 4)
    got, _ = ex._mamba(u, ex._split(torch.as_tensor(xt), rows), 4, work)
    _close(ex._join(got, rows) - torch.as_tensor(xt), jy)
    _close(pc["conv"].gather()[u.cidx], jc1)
    _close(pc["ssm"].gather()[u.cidx], js1)


def test_mamba2_replicated_inner_with_a_p_split_state():
    """mamba2-130m's ``rules_overrides`` replicate ``ssm_inner`` (every
    member holds the whole ``in_proj`` and ``out_proj``) while the cache
    rule splits its SSM state's ``P`` over ``model``: on (1, 4) each
    member holds a quarter of ``P``, and decode steps from a random state
    give JAX's tokens and states."""
    arch = "mamba2-130m"
    jlm, params, tree = _jax(arch)
    lm = _mesh_lm(arch, (1, 4), tree)
    c = lm.mamba_cfg
    assert lm.rules["ssm_inner"] is None
    for name in ("in_proj", "out_proj", "conv_w"):
        st = lm.params["layers"]["mamba"][name]
        assert "model" not in st.sharding.spec, name
        assert st.shards[0].shape == st.shape, name
    jcache, filled = _random_cache(jlm, 4, 12, 90)
    pc = lm.init_cache(4, 12)
    assert pc["ssm"].sharding.spec[3] == "model"
    assert pc["ssm"].shards[0].shape[3] == c.head_dim // 4
    for t, full in zip(ttree.leaves(pc), filled, strict=True):
        t.copy_(torch.as_tensor(full))
    _run_steps(jlm, params, jcache, lm, pc, 4, (0, 5, 11), 91)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_state_spec_on_a_stacking_axis_runs_in_the_working_layout(arch):
    """The JAX rule takes the first dimension equal to the batch: at a
    batch of 2 the reduced configs' stacking axes (mamba2's 2 layers,
    zamba2's 2 superblocks) come first, so the conv / SSM states (and
    zamba2's shared-block cache) are stored with a stacking axis over
    ``data``.  The executor regathers them into its working layout for
    the step and writes them back: the stored layout stays JAX's, and
    the tokens and states are JAX's."""
    jlm, params, tree = _jax(arch)
    jcache, filled = _random_cache(jlm, 2, 1024, 70)
    lm = _mesh_lm(arch, (2, 2), tree)
    pc = lm.init_cache(2, 1024)
    for name in ("conv", "ssm"):
        assert pc[name].sharding.spec[0] == "data", name
    lead = 1 if arch == ARCHS[0] else 2
    work = lm.cache_sharding(pc["ssm"].shape, 2, bdim=lead).spec
    assert work[0] is None and work[lead] == "data"
    for t, full in zip(ttree.leaves(pc), filled, strict=True):
        t.copy_(torch.as_tensor(full))
    _run_steps(jlm, params, jcache, lm, pc, 2, (3, 600), 71)
    assert pc["ssm"].sharding.spec[0] == "data"


# positions across the data members' 512-slot halves, the last past the
# cache (its write clamps to the last slot)
LENGTH_POS = (255, 511, 512, 1023, 1030)


@pytest.mark.parametrize("dims", [(2, 2), (4, 1)],
                         ids=lambda d: f"{d[0]}x{d[1]}")
def test_zamba2_b1_long_cache_splits_the_shared_length_over_data(dims):
    """A batch of 1 cannot split over the data members, so at 1,024
    positions the shared block's cache splits its length over ``data``
    (the heads over ``model``); decode steps from a random cache at
    positions across the slices give JAX's tokens and caches."""
    arch = "zamba2-2.7b"
    jlm, params, tree = _jax(arch)
    jcache, filled = _random_cache(jlm, 1, 1024, 80 + dims[0])
    lm = _mesh_lm(arch, dims, tree)
    pc = lm.init_cache(1, 1024)
    spec = lm.input_shardings(ShapeSpec("c", 1024, 1, "decode"))["cache"]
    for path, st in _flat(pc):
        assert st.sharding.spec == _get(spec, path).spec
    assert pc["attn"]["k"].sharding.spec[1:3] == (None, "data")
    for t, full in zip(ttree.leaves(pc), filled, strict=True):
        t.copy_(torch.as_tensor(full))
    _run_steps(jlm, params, jcache, lm, pc, 1, LENGTH_POS, 81)


# -- storage, the launcher, training, the dry-run -----------------------------------


@pytest.mark.parametrize("arch,b,cache_len",
                         [(ARCHS[0], 8, 64), (ARCHS[1], 8, 64),
                          (ARCHS[1], 1, 1024)])
def test_member_bytes_equal_the_dryrun_arguments(arch, b, cache_len):
    """Every member of a bfloat16 serving LM on the (2, 2) mesh holds its
    parameter shards, decode-cache shards (conv and SSM states, zamba2's
    shared-block cache: at a batch of 1 and 1,024 positions its length
    over ``data``) and token rows: the port dry-run's argument bytes for
    the (b, cache_len) decode cell on a (2, 2) meta mesh, to the byte."""
    cfg = reduced(get_config(arch))
    lm = LM(cfg, tp=2, mesh=mesh_from_devices(CPU4, model=2),
            dtype=torch.bfloat16)
    cache = lm.init_cache(b, cache_len)
    rows = lm._mesh_exec()._rows(b)
    stored = []
    for k in range(4):
        n = sum(t.nbytes(k) for t in ttree.leaves(lm.params))
        n += sum(t.nbytes(k) for t in ttree.leaves(cache))
        stored.append(n + len(range(b)[rows[k]]) * 4)
    meta = Mesh((torch.device("meta"),) * 4, ("data", "model"), (2, 2))
    rec = dryrun.run_cell(arch, "serve", False, roofline=False, cfg=cfg,
                          mesh=meta,
                          shape=ShapeSpec("serve", cache_len, b, "decode"))
    assert stored == [rec["memory"]["bytes"]["argument"]] * 4


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_ssm_on_a_host4_cpu_mesh(arch):
    """``launch.serve.run(mesh="host4")``: a (2, 2) mesh, tp 2; zamba2 also
    at a batch of 1 into a 1,024-position cache."""
    from repro_torch.launch.serve import run
    cases = [{"batch": 2}] + ([{"batch": 1, "cache_len": 1024}]
                              if arch == ARCHS[1] else [])
    for kw in cases:
        res = run(arch, prompt_len=5, max_new=3, device="cpu", mesh="host4",
                  **kw)
        assert res["mesh"].dims == (2, 2) and res["lm"].tp == 2
        out = res["out"]
        assert tuple(out.shape) == (kw["batch"], 3)
        assert 0 <= int(out.min()) and int(out.max()) < res["cfg"].vocab_size
        assert isinstance(res["lm"].params["embed"], ShardedTensor)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_a_mesh_names_7g(arch):
    """Item 7g is done: a train step of the ssm / hybrid families runs on
    a (2, 2) mesh (its parity: ``tests/test_torch_lm_mesh_train_ssm.py``)."""
    lm = LM(reduced(get_config(arch)), tp=2,
            mesh=mesh_from_devices(CPU4, model=2), dtype=torch.float32,
            trainable=True).init(torch.Generator().manual_seed(0))
    step = make_train_step(lm, TrainHParams(peak_lr=1e-3, warmup=0))
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, lm.cfg.vocab_size, (4, 8), np.int32)
             for k in ("tokens", "targets")}
    state, m = step(init_train_state(lm.params), batch)
    assert int(state.step) == 1 and np.isfinite(float(m["loss"]))
    assert float(m["grad_norm"]) > 0


def test_dryrun_counts_the_mamba_exchanges():
    """zamba2's decode cell on a (1, 4) meta mesh: each mamba layer's
    ``in_proj`` block exchange, per-channel leaves, norm statistics,
    ``out_proj`` rows and conv outputs are counted (``_mamba_bytes``, one
    term per layer), with the shared block's partial sums; no mesh gap.
    At a batch of 2 (a stacking-axis spec) the regather adds its bytes."""
    arch = "zamba2-2.7b"
    cfg = reduced(get_config(arch))
    meta = Mesh((torch.device("meta"),) * 4, ("data", "model"), (1, 4))
    for b in (8, 2):
        dec = dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                  global_batch=b)
        rec = dryrun.run_cell(arch, "decode_32k", False, cfg=cfg, shape=dec,
                              mesh=meta)
        assert "mesh_gap" not in rec
        lm = dryrun.make_lm(cfg, dec, meta)
        mamba = [u for u in units(lm) if u.kind == "mamba"]
        assert len(mamba) == cfg.n_layers
        per = dryrun._mamba_bytes(lm, mamba[0], dec, b, 1, 2)
        assert per > 0
        got = rec["per_device"]["collective_bytes"]
        assert got > len(mamba) * per
        assert (dryrun._regather_bytes(lm, dec) > 0) == (b == 2)
