"""Port parity for the moe family on a device mesh and for decode caches
whose spec shards their length (``models/sharded.py``), against the JAX
package on the CPU.

The JAX side is ``LM(cfg, tp=1, remat=False, compute_dtype=float32)``
unsharded, at the reduced configs (``configs/reduce.py``); its tree is
carried into a sharded port ``LM`` by ``convert.lm_params_from_numpy``.
At the reduced widths the JAX trees at ``tp`` 1, 2 and 4 are one tree
(4 query and 2 KV heads need no padding; asserted), so one JAX model
serves every mesh.  The port's meshes list the CPU four times
(``[cpu] * 4``).  Inputs come from seeded numpy generators.

Tolerances, with their reasons:

- float32 logits, decode caches and the loss: rtol 1e-4 and an absolute
  1e-4 of the compared tensor's largest magnitude (at least 1e-4), as
  ``tests/test_torch_lm_sharding.py`` (XLA and torch sum float32
  products in another order; the mesh adds the partial sums over
  ``model``, and a length-sharded cache the softmax partials, in member
  order);
- greedy tokens: equal, except where the JAX logits of the two picks lie
  within ``TIE_F32`` (1e-4) of each other;
- routing (top-k indices, keep mask, slots, the sort order) and the
  routed-expert combine: bitwise.  A routing comparison first asserts,
  as a stated precondition, that every token's k-th and (k+1)-th gates
  lie more than ``GATE_GAP`` (1e-5) apart (the moe tests' rule); the
  inputs are not re-seeded to pass it;
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
from repro.models.model import LM as JLM
from repro_torch import tree as ttree
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.configs.reduce import reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed.sharding import Mesh, ShardedTensor
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import mesh_from_devices
from repro_torch.models import sharded
from repro_torch.models.model import LM
from repro_torch.models.moe import moe_apply, moe_route

# one xdist worker per core runs these files beside the JAX suite
torch.set_num_threads(2)

MOE = ["llama4-scout-17b-a16e", "deepseek-v2-236b"]
MESH_DIMS = [(2, 2), (1, 4), (4, 1)]
TOL = 1e-4
TIE_F32 = 1e-4
GATE_GAP = 1e-5
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


def _gates_apart(gates, k: int) -> None:
    """The stated precondition of a routing comparison."""
    s = -np.sort(-np.asarray(gates, np.float32), axis=-1)
    if s.shape[-1] > k:
        gap = (s[..., k - 1] - s[..., k]).min()
        assert gap > GATE_GAP, f"a top-k near-tie ({gap:.2e}) in the inputs"


def _jax(arch):
    jlm = JLM(jreduced(jget_config(arch)), tp=1, remat=False,
              compute_dtype=jnp.float32)
    params = jlm.init(jax.random.key(7))
    return jlm, params, jax.tree.map(np.asarray, params)


def _mesh_lm(arch, dims, tree, dtype=torch.float32):
    data, model = dims
    mesh = mesh_from_devices(CPU4, model=model)
    assert mesh.dims == dims
    lm = LM(reduced(get_config(arch)), tp=model, mesh=mesh, dtype=dtype)
    for path, st in _flat(lm.params):     # one tree serves every tp
        assert st.shape == np.shape(_get(tree, path)), path
    lm_params_from_numpy(tree, lm)
    return lm


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


def _gathered(cache):
    return [t.gather().numpy() for t in ttree.leaves(cache)]


# -- the LM on the mesh against JAX -------------------------------------------


@pytest.fixture(scope="module", params=MOE)
def ref(request):
    """The JAX LM's float32 outputs on one batch: every position's
    logits, the prefill token and cache, 4 decode steps from a cache of
    12 (tokens and caches) and the loss."""
    arch = request.param
    jlm, params, tree = _jax(arch)
    cfg = jlm.cfg
    rng = np.random.default_rng(1 + MOE.index(arch))
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
def test_moe_mesh_matches_jax(ref, dims):
    """Prefill logits, next token and cache, 4 decode steps (tokens and
    the gathered cache) and the ``loss`` value on the CPU mesh, against
    the unsharded JAX LM on the same weights."""
    lm = _mesh_lm(ref["arch"], dims, ref["tree"])
    tb = {k: torch.as_tensor(v) for k, v in ref["batch"].items()}
    _close(lm._mesh_exec().logits({"tokens": tb["tokens"]}), ref["logits"])
    tok, cache = lm.prefill({"tokens": tb["tokens"]})
    _tokens_agree(tok, ref["tok"], ref["logits"][:, -1])
    leaves = ttree.leaves(cache)
    assert all(isinstance(t, ShardedTensor) for t in leaves)
    for got, want in zip(_gathered(cache), ref["prefill_cache"], strict=True):
        _close(got, want)
    pc = lm.init_cache(4, 12)
    for pos, want in enumerate(ref["steps"]):
        nxt, pc = lm.decode_step(pc, tb["tokens"][:, pos:pos + 1], pos)
        np.testing.assert_array_equal(nxt.numpy(), want)
    for got, want in zip(_gathered(pc), ref["decode_cache"], strict=True):
        _close(got, want)
    loss, _ = lm.loss(tb)
    _close(loss, ref["loss"])


# -- routing and the combine ------------------------------------------------------


def _moe_inputs(lm, rng, b, s, shared_dir=False):
    """A global (b, s, d) input (rows sharing one direction with
    ``shared_dir``, so they favour the same experts), the mesh's rows
    and per-member slices, the first MoE unit, and its unsharded
    leaves."""
    d = lm.cfg.d_model
    x = rng.normal(0, 1, (b, s, d))
    if shared_dir:
        x = x + rng.normal(0, 1, (d,))
    x = torch.as_tensor(x.astype(np.float32))
    ex = lm._mesh_exec()
    u = next(u for u in ex.units if u.ffn == "moe")
    rows = ex._rows(b)
    hs = ex._split(x, rows)
    p = _get(lm.gather_params(), u.prefix + ("moe",))
    p = ttree.unflatten(p, iter([t[u.idx] for t in ttree.leaves(p)]))
    return x, ex, u, rows, hs, p


def _scale_router(lm, u, scale):
    st = _get(lm.params, u.prefix + ("moe", "router"))
    for t in st.shards:
        t[u.idx].mul_(scale)


def _jax_routing(c, router, xt):
    """The first lines of the JAX ``moe_apply``, on the same inputs."""
    logits = (jnp.asarray(xt) @ jnp.asarray(router)).astype(jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    _, top_i = jax.lax.top_k(gates, c.top_k)
    t = xt.shape[0]
    cap = int(max(1, c.capacity_factor * t * c.top_k / c.n_experts))
    flat_e = top_i.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    counts = jnp.bincount(sorted_e, length=c.n_experts)
    starts = jnp.cumsum(counts) - counts
    slot = jnp.arange(t * c.top_k) - starts[sorted_e]
    return {"gates": np.asarray(gates), "top_i": np.asarray(top_i),
            "order": np.asarray(order), "slot": np.asarray(slot),
            "keep": np.asarray(slot < cap), "cap": cap}


@pytest.mark.parametrize("dims", MESH_DIMS, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("arch", MOE)
def test_routing_is_jax_bitwise_and_routes_once(arch, dims, monkeypatch):
    """On every mesh: the first MoE layer's routing of a (4, 6) batch
    whose tokens share one direction (the router scaled by 8, so the
    capacity drops tokens) is the JAX ``moe_apply``'s, index for index,
    and ``moe_route`` runs once a layer, on the first member."""
    _, _, tree = _jax(arch)
    lm = _mesh_lm(arch, dims, tree)
    rng = np.random.default_rng(20 + MOE.index(arch))
    x, ex, u, rows, hs, p = _moe_inputs(lm, rng, 4, 6, shared_dir=True)
    _scale_router(lm, u, 8.0)
    calls = []
    monkeypatch.setattr(sharded, "moe_route",
                        lambda *a: calls.append(a[2].device) or
                        moe_route(*a))
    r, xt = ex.route(u, hs, rows)
    assert len(calls) == 1 and calls[0] == lm.mesh.devices[0]
    np.testing.assert_array_equal(xt.numpy(), x.reshape(-1, x.shape[-1]))
    c = lm.moe_cfg
    want = _jax_routing(c, p["router"].numpy() * 8.0, xt.numpy())
    _gates_apart(want["gates"], c.top_k)
    assert r.cap == want["cap"]
    for name in ("top_i", "order", "slot", "keep"):
        np.testing.assert_array_equal(getattr(r, name).numpy(), want[name],
                                      err_msg=name)
    assert (~r.keep).sum() > 0, "the capacity must drop tokens here"


@pytest.mark.parametrize("dims", MESH_DIMS, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("arch", MOE)
def test_moe_combine_equals_the_unsharded_port_bitwise(arch, dims):
    """The routed experts on the mesh (dispatch from the rows' owners,
    each member's expert block, the running sum passed in model order)
    equal the unsharded ``moe_apply`` bitwise in float32, dropped tokens
    included: the config without its shared experts, whose partial sums
    over ``model`` would add in another order."""
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              n_shared_experts=0, shared_d_ff=0)
    mesh = mesh_from_devices(CPU4, model=dims[1])
    lm = LM(cfg, tp=dims[1], mesh=mesh, dtype=torch.float32).init(
        torch.Generator().manual_seed(31))
    rng = np.random.default_rng(30 + MOE.index(arch))
    x, ex, u, rows, hs, p = _moe_inputs(lm, rng, 4, 6, shared_dir=True)
    _scale_router(lm, u, 8.0)
    p["router"] = p["router"] * 8.0
    c = lm.moe_cfg
    assert c.n_shared == 0 and "shared" not in p
    r = moe_route(c, p["router"], x.reshape(-1, x.shape[-1]))
    _gates_apart(r.gates.numpy(), c.top_k)
    assert (~r.keep).sum() > 0
    routed = ex._join(ex.moe(u, hs, rows), rows)
    np.testing.assert_array_equal(routed.numpy(), moe_apply(c, p, x).numpy())


def test_r7_decode_drops_the_same_tokens_on_a_batch_split_mesh():
    """ROADMAP.md, R7, on the (2, 2) mesh whose data members hold 4 rows
    each: a decode step of 8 identical rows routes over the global
    T = 8 (capacity int(1.25·8·1/4) = 2 at llama4-reduced's E = 4, k = 1),
    so rows 0 and 1 keep their expert and rows 2–7 drop, as unsharded;
    the outputs equal the unsharded ``moe_apply``'s."""
    _, _, tree = _jax(MOE[0])
    lm = _mesh_lm(MOE[0], (2, 2), tree)
    ex = lm._mesh_exec()
    u = next(u for u in ex.units if u.ffn == "moe")
    rows = ex._rows(8)
    assert rows[0] == slice(0, 4) and rows[2] == slice(4, 8)
    row = np.random.default_rng(40).normal(0, 1, (1, 1, lm.cfg.d_model))
    x = torch.as_tensor(np.repeat(row, 8, axis=0).astype(np.float32))
    hs = ex._split(x, rows)
    p = _get(lm.gather_params(), u.prefix + ("moe",))
    p = ttree.unflatten(p, iter([t[u.idx] for t in ttree.leaves(p)]))
    c = lm.moe_cfg
    want = moe_route(c, p["router"], x.reshape(8, -1))
    _gates_apart(want.gates.numpy()[:1], c.top_k)
    r, _ = ex.route(u, hs, rows)
    assert r.cap == want.cap == 2
    np.testing.assert_array_equal(r.keep.numpy(), want.keep.numpy())
    kept = r.keep.numpy()[np.argsort(r.order.numpy())]
    assert kept.tolist() == [True, True] + [False] * 6
    got = ex._join(ex.moe(u, hs, rows), rows).numpy()
    _close(got, moe_apply(c, p, x).numpy())
    assert np.abs(got[2:] - got[:1]).max() > 1e-3
    np.testing.assert_array_equal(got[2:], np.broadcast_to(got[2:3],
                                                           got[2:].shape))


# -- length-sharded decode caches ------------------------------------------------

# (arch, mesh, batch, the leaf whose spec the case is about, the spec
# entries expected at (batch dim, length dim)); cache of 1,024 positions
LENGTH_CASES = {
    # 2 KV heads on a 4-way model axis stay replicated: length over model
    "tinyllama-tp4": ("tinyllama-1.1b", (1, 4), 4, ("k",), ("data", "model")),
    "tinyllama-tp4-B1": ("tinyllama-1.1b", (1, 4), 1, ("k",),
                         ("data", "model")),
    # B=1 does not split over 2 data members: the length goes over data
    "tinyllama-2x2-B1": ("tinyllama-1.1b", (2, 2), 1, ("k",),
                         (None, "data")),
    "tinyllama-4x1-B1": ("tinyllama-1.1b", (4, 1), 1, ("k",),
                         (None, "data")),
    # the latent cache has no head axis: its length goes over model
    "deepseek-tp4": ("deepseek-v2-236b", (1, 4), 4, ("rest", "ckv"),
                     ("data", "model")),
    "deepseek-2x2": ("deepseek-v2-236b", (2, 2), 4, ("first", "kpe"),
                     ("data", "model")),
    # llama4's global layers at tp 4 (its 16-slot local rings stay whole)
    "llama4-tp4": ("llama4-scout-17b-a16e", (1, 4), 4, ("global", "v"),
                   ("data", "model")),
}
# positions across the members' slices (256 each at tp 4), the last past
# the cache (its write clamps to the last slot)
LENGTH_POS = (255, 256, 700, 1023, 1030)


def _jax_cached(arch, b, cache_len, seed):
    """The JAX LM, its params and tree, and a decode cache of random
    entries (numpy leaves in ``jax.tree.leaves`` order)."""
    jlm, params, tree = _jax(arch)
    jcache = jlm.init_cache(b, cache_len)
    rng = np.random.default_rng(seed)
    filled = [rng.normal(0, 1, np.shape(x)).astype(np.float32)
              for x in jax.tree.leaves(jcache)]
    jcache = jax.tree.unflatten(jax.tree.structure(jcache),
                                [jnp.asarray(x) for x in filled])
    return jlm, params, tree, jcache, filled


@pytest.mark.parametrize("case", list(LENGTH_CASES))
def test_length_sharded_decode_matches_jax(case):
    """``init_cache`` builds the layout ``input_shardings`` gives (the
    length split as the case says), and decode steps at positions across
    the members' slices, from a cache of random entries, give JAX's
    tokens and caches."""
    arch, dims, b, leaf, (bspec, sspec) = LENGTH_CASES[case]
    jlm, params, tree, jcache, filled = _jax_cached(
        arch, b, 1024, 50 + list(LENGTH_CASES).index(case))
    lm = _mesh_lm(arch, dims, tree)
    pc = lm.init_cache(b, 1024)
    spec = lm.input_shardings(ShapeSpec("c", 1024, b, "decode"))["cache"]
    for path, st in _flat(pc):
        assert st.sharding.spec == _get(spec, path).spec
    st = _get(pc, leaf)
    bdim = len(st.shape) - (3 if leaf[-1] in ("ckv", "kpe") else 4)
    assert (st.sharding.spec[bdim], st.sharding.spec[bdim + 1]) == \
        (bspec, sspec)
    for t, full in zip(ttree.leaves(pc), filled, strict=True):
        t.copy_(torch.as_tensor(full))
    toks = np.random.default_rng(60).integers(
        0, lm.cfg.vocab_size, (len(LENGTH_POS), b, 1), np.int32)
    step = jax.jit(jlm.decode_step)
    for pos, tok in zip(LENGTH_POS, toks):
        want, jcache = step(params, jcache, jnp.asarray(tok),
                            jnp.int32(pos))
        got, pc = lm.decode_step(pc, torch.as_tensor(tok), pos)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"position {pos}")
    for got, want in zip(_gathered(pc), jax.tree.leaves(jcache),
                         strict=True):
        _close(got, want)


def test_a_cache_spec_on_a_stacking_axis_runs_in_the_working_layout():
    """The JAX rule takes the first dimension equal to the batch: at
    tinyllama-reduced's 2 layers and a batch of 2 the dense cache's spec
    shards the layer axis over ``data`` (and the batch axis stands where
    the length was).  The executor regathers such a leaf into its working
    layout for the step and writes it back: the stored layout stays
    JAX's, and the tokens and cache are JAX's."""
    arch = "tinyllama-1.1b"
    jlm, params, tree, jcache, filled = _jax_cached(arch, 2, 1024, 70)
    lm = _mesh_lm(arch, (2, 2), tree)
    pc = lm.init_cache(2, 1024)
    assert pc["k"].sharding.spec[0] == "data"       # the stacking axis
    want_spec = lm.cache_sharding(pc["k"].shape, 2, bdim=1)
    assert want_spec.spec[:3] == (None, "data", None)
    for t, full in zip(ttree.leaves(pc), filled, strict=True):
        t.copy_(torch.as_tensor(full))
    step = jax.jit(jlm.decode_step)
    for pos in (3, 600):
        tok = np.full((2, 1), pos % lm.cfg.vocab_size, np.int32)
        want, jcache = step(params, jcache, jnp.asarray(tok), jnp.int32(pos))
        got, pc = lm.decode_step(pc, torch.as_tensor(tok), pos)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pc["k"].sharding.spec[0] == "data"
    for got, want in zip(_gathered(pc), jax.tree.leaves(jcache),
                         strict=True):
        _close(got, want)


# -- storage and the launcher ------------------------------------------------------


@pytest.mark.parametrize("arch,cache_len", [(MOE[0], 64), (MOE[1], 1024)])
def test_member_bytes_equal_the_dryrun_arguments(arch, cache_len):
    """Every member of a bfloat16 serving LM on the (2, 2) mesh holds its
    parameter shards, decode-cache shards (deepseek's at 1,024 positions
    length-sharded) and token rows: the port dry-run's argument bytes for
    the (8, cache_len) decode cell on a (2, 2) meta mesh, to the byte."""
    cfg = reduced(get_config(arch))
    lm = LM(cfg, tp=2, mesh=mesh_from_devices(CPU4, model=2),
            dtype=torch.bfloat16)
    cache = lm.init_cache(8, cache_len)
    rows = lm._mesh_exec()._rows(8)
    stored = []
    for k in range(4):
        n = sum(t.nbytes(k) for t in ttree.leaves(lm.params))
        n += sum(t.nbytes(k) for t in ttree.leaves(cache))
        stored.append(n + len(range(8)[rows[k]]) * 4)
    meta = Mesh((torch.device("meta"),) * 4, ("data", "model"), (2, 2))
    rec = dryrun.run_cell(arch, "serve", False, roofline=False, cfg=cfg,
                          mesh=meta,
                          shape=ShapeSpec("serve", cache_len, 8, "decode"))
    assert stored == [rec["memory"]["bytes"]["argument"]] * 4
    if cache_len >= 1024:
        assert "model" in cache["rest"]["ckv"].sharding.spec


@pytest.mark.parametrize("arch", MOE)
def test_serve_launcher_runs_moe_on_a_host4_cpu_mesh(arch):
    """``launch.serve.run(mesh="host4")``: a (2, 2) mesh, tp 2; deepseek
    with a 1,024-position cache (its latent length split over
    ``model``)."""
    from repro_torch.launch.serve import run
    kw = {"cache_len": 1024} if arch == MOE[1] else {}
    res = run(arch, batch=2, prompt_len=5, max_new=3, device="cpu",
              mesh="host4", **kw)
    assert res["mesh"].dims == (2, 2) and res["lm"].tp == 2
    out = res["out"]
    assert tuple(out.shape) == (2, 3)
    assert 0 <= int(out.min()) and int(out.max()) < res["cfg"].vocab_size
    assert isinstance(res["lm"].params["embed"], ShardedTensor)


def test_dryrun_counts_moe_and_length_sharded_collectives():
    """deepseek's decode cell on a (2, 2) meta mesh (its latent length
    over ``model``) and tinyllama's on (1, 4) (2 KV heads on 4: the
    length over ``model``) run sequence-parallel and get collective
    bytes, the softmax partials among them, and no mesh gap; so does a
    moe train cell (item 7g is done)."""
    dec = dataclasses.replace(SHAPES["decode_32k"], seq_len=1024,
                              global_batch=8)
    for arch, dims in ((MOE[1], (2, 2)), ("tinyllama-1.1b", (1, 4))):
        meta = Mesh((torch.device("meta"),) * 4, ("data", "model"), dims)
        cfg = reduced(get_config(arch))
        rec = dryrun.run_cell(arch, "decode_32k", False, cfg=cfg, shape=dec,
                              mesh=meta)
        assert "mesh_gap" not in rec
        lm = dryrun.make_lm(cfg, dec, meta)
        split = dryrun.length_sharded(lm, dec)
        assert len(split) == cfg.n_layers
        assert all(axes == ("model",) for _, axes in split)
        got = rec["per_device"]["collective_bytes"]
        assert got > sum(dryrun._softmax_bytes(lm, u, axes, 8 // dims[0], 2)
                         for u, axes in split) > 0
    meta = Mesh((torch.device("meta"),) * 4, ("data", "model"), (2, 2))
    train = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=8)
    rec = dryrun.run_cell(MOE[0], "train_4k", False,
                          cfg=reduced(get_config(MOE[0])), shape=train,
                          mesh=meta)
    assert "mesh_gap" not in rec
    assert rec["per_device"]["collective_bytes"] > 0


def test_moe_apply_takes_the_jax_sharding_hooks():
    """``moe_apply(constrain=, dp_groups=)``: ``dp_groups`` is ignored and
    ``constrain`` is called with JAX's logical axes at JAX's points, in
    order; its result is used where it is a tensor (the port's ``LM``
    constrainer returns a ``NamedSharding`` and changes nothing)."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe
    args = (64, 8, 2, 64, 2, 128)
    c, jc = moe.MoECfg(*args), jmoe.MoECfg(*args)
    rng = np.random.default_rng(80)
    p = {"router": rng.normal(0, 0.3, (64, 8)),
         "w1": rng.normal(0, 0.1, (8, 64, 64)),
         "w3": rng.normal(0, 0.1, (8, 64, 64)),
         "w2": rng.normal(0, 0.1, (8, 64, 64)),
         "shared": {"w1": rng.normal(0, 0.1, (64, 128)),
                    "w3": rng.normal(0, 0.1, (64, 128)),
                    "w2": rng.normal(0, 0.1, (128, 64))}}
    p = jax.tree.map(lambda a: a.astype(np.float32), p)
    tp = jax.tree.map(torch.as_tensor, p)
    x = rng.normal(0, 1, (2, 5, 64)).astype(np.float32)
    seen = {"jax": [], "port": []}

    def rec(key):
        def hook(t, *axes):
            seen[key].append(axes)
            return t
        return hook
    jmoe.moe_apply(jc, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                   constrain=rec("jax"), dp_groups=4)
    plain = moe_apply(c, tp, torch.as_tensor(x))
    hooked = moe_apply(c, tp, torch.as_tensor(x), constrain=rec("port"),
                       dp_groups=4)
    assert seen["port"] == seen["jax"] and len(seen["jax"]) == 7
    np.testing.assert_array_equal(hooked.numpy(), plain.numpy())
    lm = LM(reduced(get_config(MOE[1])), tp=2,
            mesh=mesh_from_devices(CPU4, model=2), dtype=torch.float32)
    got = moe_apply(c, tp, torch.as_tensor(x), constrain=lm._c)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    copied = moe_apply(c, tp, torch.as_tensor(x),
                        constrain=lambda t, *a: t * 1.0)
    np.testing.assert_array_equal(copied.numpy(), plain.numpy())
