"""Port parity for LM sharding on a device mesh: the logical-axis rules
(``distributed/sharding.py``'s ``make_rules`` / ``batch_axes`` /
``constrainer``), the parameter and input specs of every config
(``LM.param_specs`` / ``input_specs`` / ``input_shardings``) and dense
execution over CPU meshes (``models/sharded.py``), against the JAX
package on the CPU.

The JAX side of the metadata runs on ``jax.sharding.AbstractMesh``
(no devices): ``NamedSharding(abstract_mesh, spec).shard_shape`` gives
its shard shapes.  The JAX side of execution is ``LM(cfg, tp=...,
remat=False, compute_dtype=float32)`` unsharded, at the reduced configs
(``configs/reduce.py``: 4 query and 2 KV heads, so ``tp = 4`` keeps the
KV heads replicated); its tree is carried into a sharded port ``LM`` by
``convert.lm_params_from_numpy``.  The port's meshes list the CPU four
times (``[cpu] * 4``).  Inputs come from seeded numpy generators.

Tolerances, with their reasons:

- specs, shard shapes, member storage and the gathers of every leaf:
  exact (a gather is a ``.to()`` and a concatenation);
- float32 logits and decode caches: rtol 1e-4 and an absolute 1e-4 of
  the compared tensor's largest magnitude (at least 1e-4), as
  ``tests/test_torch_cuda.py`` holds the card to the CPU (XLA and torch
  sum float32 products in another order; the mesh adds the partial sums
  over ``model`` in member order);
- greedy tokens: equal, except where the JAX logits of the two picks lie
  within ``TIE_F32`` (1e-4) of each other;
- ``loss``: rtol 1e-5 (the mesh sums each data shard's token losses,
  then the shards, in fixed order);
- every leaf's gradient: within 5e-4 of that leaf's largest JAX
  magnitude, as ``tests/test_torch_lm_train.py``;
- two train steps on the (2, 2) mesh against the unsharded port: the
  parameters within a tenth of the summed learning rates at every entry
  and a thousandth of it on average, the moments within 5e-4 of their
  largest entry, ``loss`` rtol 1e-5 and ``grad_norm`` rtol 5e-4, the
  bounds of ``tests/test_torch_lm_train.py``'s step test;
- checkpoints restored across meshes: bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs.reduce import reduced as jreduced
from repro.distributed.sharding import batch_axes as jbatch_axes
from repro.distributed.sharding import constrainer as jconstrainer
from repro.distributed.sharding import make_rules as jmake_rules
from repro.models.model import LM as JLM
from repro_torch import checkpoint as ckpt
from repro_torch import tree as ttree
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.reduce import reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed.fault_tolerance import (ElasticRunner,
                                                     _restore_like)
from repro_torch.distributed.sharding import (Mesh, ShardedTensor,
                                              batch_axes, constrainer,
                                              make_rules)
from repro_torch.launch.mesh import (make_production_mesh, mesh_from_devices,
                                     mesh_from_flag)
from repro_torch.models.model import LM
from repro_torch.train.step import (TrainHParams, init_train_state,
                                    make_train_step)

# one xdist worker per core runs these files beside the JAX suite
torch.set_num_threads(2)

ARCHS = ["llama4-scout-17b-a16e", "deepseek-v2-236b", "zamba2-2.7b",
         "seamless-m4t-large-v2", "internvl2-26b", "qwen1.5-110b",
         "starcoder2-7b", "qwen1.5-4b", "tinyllama-1.1b", "mamba2-130m"]
DENSE = ["tinyllama-1.1b", "qwen1.5-4b", "starcoder2-7b", "internvl2-26b"]
MESH_DIMS = [(2, 2), (1, 4), (4, 1)]
TIE_F32 = 1e-4
GRAD_TOL = 5e-4
CPU4 = [torch.device("cpu")] * 4
META = torch.device("meta")

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


def _meshes(name):
    """The JAX abstract mesh and the port's meta-device mesh of one
    shape."""
    dims, axes = MESHES[name]
    n = int(np.prod(dims))
    return AbstractMesh(dims, axes), Mesh((META,) * n, axes, dims)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _spec(s):
    """A JAX ``PartitionSpec`` or the port's as a plain tuple."""
    return tuple(s)


# -- (a) rules ---------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rules_batch_axes_and_constrainer_equal_jax(mesh_name, monkeypatch):
    am, pm = _meshes(mesh_name)
    # JAX's constrainer hands its NamedSharding to with_sharding_constraint:
    # capture it instead of constraining
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, sharding: sharding)
    overrides = {(): ()}
    for arch in ARCHS:
        overrides[get_config(arch).rules_overrides] = \
            jget_config(arch).rules_overrides
    rng = np.random.default_rng(0)
    for ov, jov in overrides.items():
        jr, pr = jmake_rules(am, jov), make_rules(pm, ov)
        assert pr == jr
        for batch in (1, 2, 3, 4, 8, 32, 128, 256, 512, 24):
            assert batch_axes(pr, batch, pm) == jbatch_axes(jr, batch, am)
        jc, pc = jconstrainer(am, jr), constrainer(pm, pr)
        logical = [None, "batch", "embed", "vocab", "heads", "kv_seq",
                   "act_seq", "tokens", "mlp", ("data", "model")]
        for _ in range(40):
            nd = int(rng.integers(1, 5))
            shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 16, 32, 48, 256]))
                          for _ in range(nd))
            axes = [logical[i] for i in
                    rng.integers(0, len(logical), nd + int(rng.integers(0,
                                                                         2)))]
            axes = [a for a in axes if not (isinstance(a, tuple) and
                                            any(n not in pm.axis_names
                                                for n in a))]
            if any(a == "kv_seq" for a in axes):
                pr.setdefault("kv_seq", "model")
                jr.setdefault("kv_seq", "model")
            try:
                want = jc(jax.ShapeDtypeStruct(shape, jnp.float32), *axes)
            except Exception as e:  # an axis used twice: both refuse it
                if type(e).__name__ != "DuplicateSpecError":
                    raise
                with pytest.raises(ValueError, match="does not fit"):
                    pc(torch.empty(shape, device=META), *axes)
                continue
            got = pc(torch.empty(shape, device=META), *axes)
            assert _spec(got.spec) == _spec(want.spec), (shape, axes)
    assert make_rules(None) == jmake_rules(None)
    assert constrainer(None, make_rules(None))(torch.zeros(2), "batch") \
        is None


# -- (b) specs ---------------------------------------------------------------


def _check_specs(jlm, lm, am, shapes):
    js, ps = dict(_flat(jlm.param_specs())), dict(_flat(lm.param_specs()))
    assert js.keys() == ps.keys()
    for path, spec in js.items():
        assert _spec(ps[path]) == _spec(spec), path
    jdefs = {p: d for p, d in _flat_defs(jlm.param_defs())}
    for path, st in _flat(lm.params):
        want = JNamedSharding(am, js[path]).shard_shape(jdefs[path].shape)
        assert st.sharding.shard_shape(st.shape) == tuple(want), path
        assert all(tuple(t.shape) == tuple(want) for t in st.shards), path
    for name in shapes:
        jin, pin = jlm.input_specs(JSHAPES[name]), lm.input_specs(SHAPES[name])
        jsh = jlm.input_shardings(JSHAPES[name])
        psh = lm.input_shardings(SHAPES[name])
        jflat, pflat = dict(_flat(jin)), dict(_flat(pin))
        assert jflat.keys() == pflat.keys() == dict(_flat(psh)).keys()
        for path, want in jflat.items():
            got = pflat[path]
            assert got.device == META
            assert tuple(got.shape) == tuple(want.shape), (name, path)
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
            js_ = _get(jsh, path)
            ps_ = _get(psh, path)
            assert _spec(ps_.spec) == _spec(js_.spec), (name, path)
            assert ps_.shard_shape(got.shape) == \
                tuple(js_.shard_shape(want.shape)), (name, path)


def _flat_defs(defs, prefix=()):
    from repro.models.common import ParamDef
    if isinstance(defs, ParamDef):
        yield prefix, defs
        return
    for k in sorted(defs):
        yield from _flat_defs(defs[k], prefix + (k,))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_shard_shapes_equal_jax_on_production_meshes(arch):
    """Every config at ``tp=16`` on (16, 16) and (2, 16, 16): the
    parameter specs, each leaf's shard shape (and the port's storage of
    it), and every ``SHAPES`` entry's input specs and shardings."""
    for mesh_name in ("single", "multi"):
        am, pm = _meshes(mesh_name)
        jlm = JLM(jget_config(arch), tp=16, mesh=am)
        lm = LM(get_config(arch), tp=16, mesh=pm)
        _check_specs(jlm, lm, am, list(SHAPES))


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax_reduced_on_2x2(arch):
    am, pm = _meshes("2x2")
    jlm = JLM(jreduced(jget_config(arch)), tp=2, mesh=am)
    lm = LM(reduced(get_config(arch)), tp=2, mesh=pm)
    assert lm.rules == jlm.rules
    _check_specs(jlm, lm, am, list(SHAPES))


def test_shard_shape_raises_where_a_dimension_does_not_divide():
    _, pm = _meshes("2x2")
    from repro_torch.distributed.sharding import NamedSharding
    sh = NamedSharding(pm, ("data", "model"))
    assert sh.shard_shape((4, 6, 5)) == (2, 3, 5)
    with pytest.raises(ValueError, match="does not split"):
        sh.shard_shape((3, 6))
    with pytest.raises(ValueError, match="does not fit"):
        NamedSharding(pm, ("data", "data"))
    with pytest.raises(ValueError, match="does not fit"):
        NamedSharding(pm, ("pod",))


# -- (c) dense execution -----------------------------------------------------


def _pair(arch, dims, seed=1):
    """The JAX LM (unsharded, float32) with its params, and a trainable
    port LM on the CPU mesh ``dims`` holding the same weights."""
    data, model = dims
    jlm = JLM(jreduced(jget_config(arch)), tp=model, remat=False,
              compute_dtype=jnp.float32)
    params = jlm.init(jax.random.key(seed))
    mesh = mesh_from_devices(CPU4, model=model)
    assert mesh.dims == dims
    lm = LM(reduced(get_config(arch)), tp=model, mesh=mesh,
            dtype=torch.float32, trainable=True, remat=False)
    lm_params_from_numpy(jax.tree.map(np.asarray, params), lm)
    return jlm, params, lm


def _batch(cfg, rng, b=4, s=8):
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (b, s), np.int32)}
    if cfg.prefix_len:
        out["prefix"] = rng.normal(0, 1, (b, cfg.prefix_len, cfg.d_model)) \
            .astype(np.float32)
    return out


def _close(got, want):
    """float32 logits / caches: rtol 1e-4, atol 1e-4 of the largest
    magnitude (at least 1e-4)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=1e-4,
        atol=1e-4 * max(1.0, float(np.abs(want).max(initial=0.0))))


def _tokens_agree(got, want, logits):
    """Greedy picks equal up to near ties in the JAX ``logits`` (B, V)."""
    got, want = np.asarray(got), np.asarray(want)
    logits = np.asarray(logits)
    for i in np.nonzero(got != want)[0]:
        assert abs(logits[i, got[i]] - logits[i, want[i]]) <= TIE_F32, \
            (i, got[i], want[i])


def _assert_storage(lm, params):
    """Each member holds its shard's shape, and the gathers equal the JAX
    leaves bitwise."""
    gathered = lm.gather_params()
    for path, st in _flat(lm.params):
        assert isinstance(st, ShardedTensor)
        local = st.sharding.shard_shape(st.shape)
        for k, t in enumerate(st.shards):
            assert tuple(t.shape) == local
            idx = st.sharding.member_index(k, st.shape)
            np.testing.assert_array_equal(
                t.detach().numpy(), np.asarray(_get(params, path))[idx])
        np.testing.assert_array_equal(_get(gathered, path).numpy(),
                                      np.asarray(_get(params, path)))


@pytest.mark.parametrize("dims", MESH_DIMS, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("arch", DENSE)
def test_dense_mesh_matches_jax(arch, dims):
    """Prefill logits and next token, 4 decode steps (tokens and the
    cache), ``loss`` and every leaf's gradient on the CPU mesh, against
    the unsharded JAX LM on the same weights."""
    jlm, params, lm = _pair(arch, dims)
    cfg = lm.cfg
    _assert_storage(lm, params)
    rng = np.random.default_rng(10 * DENSE.index(arch)
                                + MESH_DIMS.index(dims))
    batch = _batch(cfg, rng)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    kw = {"prefix": jb["prefix"]} if cfg.prefix_len else {}
    h, _ = jlm._forward(params, jb["tokens"], **kw)
    want_logits = np.asarray(jlm._logits(params, h))
    got_logits = lm._mesh_exec().logits(tb).numpy()
    _close(got_logits, want_logits)
    jtok, _ = jlm.prefill(params, jb)
    tok, cache = lm.prefill(tb)
    _tokens_agree(tok, jtok, want_logits[:, -1])
    assert all(isinstance(t, ShardedTensor) for t in cache)

    if not cfg.prefix_len:
        b, s = batch["tokens"].shape
        jstep = jax.jit(jlm.decode_step)
        jcache = jlm.init_cache(b, s + 4)
        pcache = lm.init_cache(b, s + 4)
        for pos in range(4):
            t = batch["tokens"][:, pos:pos + 1]
            jnext, jcache = jstep(params, jcache, jnp.asarray(t),
                                  jnp.int32(pos))
            nxt, pcache = lm.decode_step(pcache, torch.as_tensor(t), pos)
            np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
        for name in ("k", "v"):
            _close(pcache[name].gather().numpy(), jcache[name])

    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.loss(p, jb), has_aux=True)(params)
    loss, m = lm.loss(tb)
    loss.backward()
    lm.reduce_grads()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(m["acc"]) == pytest.approx(float(jm["acc"]))
    for path, g in _flat(lm.grads):
        want = np.asarray(_get(jgrads, path), dtype=np.float32)
        np.testing.assert_allclose(g.gather().numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg="/".join(path))


def test_dense_mesh_with_an_unsharded_batch_matches_the_unsharded_port():
    """A batch of 3 on the (2, 2) mesh does not divide the data extent:
    every data member holds it all, and ``loss``, its gradients and the
    served tokens equal the unsharded port's."""
    cfg = reduced(get_config("qwen1.5-4b"))
    ref = LM(cfg, tp=2, device="cpu", dtype=torch.float32, trainable=True,
             remat=False).init(torch.Generator().manual_seed(3))
    lm = LM(cfg, tp=2, mesh=mesh_from_devices(CPU4, model=2),
            dtype=torch.float32, trainable=True, remat=True)
    for path, t in _flat(ref.params):
        lm.load_leaf(path, t)
    rng = np.random.default_rng(5)
    tb = {k: torch.as_tensor(v) for k, v in _batch(cfg, rng, b=3).items()}
    assert lm._mesh_exec()._rows(3) == [slice(None)] * 4
    l1, _ = ref.loss(tb)
    l1.backward()
    l2, _ = lm.loss(tb)
    l2.backward()
    lm.reduce_grads()
    np.testing.assert_allclose(float(l2.detach()), float(l1.detach()),
                               rtol=1e-5)
    for path, g in _flat(lm.grads):
        want = _get(ref.grads, path).numpy()
        full = g.gather().numpy()
        np.testing.assert_allclose(full, want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())
        for k, t in enumerate(g.shards):    # replicated copies agree
            np.testing.assert_array_equal(
                t.numpy(), full[g.sharding.member_index(k, g.shape)])
    with torch.no_grad():
        want_tok, _ = ref.prefill(tb)
    got_tok, _ = lm.prefill(tb)
    np.testing.assert_array_equal(got_tok.numpy(), want_tok.numpy())


# -- (d) training and restore --------------------------------------------------


def _train_pair(arch="tinyllama-1.1b", seed=2):
    cfg = reduced(get_config(arch))
    ref = LM(cfg, tp=2, device="cpu", dtype=torch.float32, trainable=True,
             remat=True).init(torch.Generator().manual_seed(seed))
    lm = LM(cfg, tp=2, mesh=mesh_from_devices(CPU4, model=2),
            dtype=torch.float32, trainable=True, remat=True)
    for path, t in _flat(ref.params):
        lm.load_leaf(path, t)
    return cfg, ref, lm


def test_two_train_steps_on_2x2_match_the_unsharded_port(tmp_path):
    cfg, ref, lm = _train_pair()
    hp = TrainHParams(peak_lr=1e-3, warmup=0, total_steps=10, n_micro=2)
    s_ref, s_mesh = init_train_state(ref.params), init_train_state(lm.params)
    step_ref, step_mesh = make_train_step(ref, hp), make_train_step(lm, hp)
    rng = np.random.default_rng(11)
    lr_sum = 0.0
    for _ in range(2):
        batch = _batch(cfg, rng)
        s_ref, m_ref = step_ref(s_ref, batch)
        s_mesh, m_mesh = step_mesh(s_mesh, batch)
        lr_sum += float(m_ref["lr"])
        np.testing.assert_allclose(float(m_mesh["loss"]),
                                   float(m_ref["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m_mesh["grad_norm"]),
                                   float(m_ref["grad_norm"]), rtol=5e-4)
    for path, st in _flat(s_mesh.params):
        got = st.gather().numpy()
        want = _get(s_ref.params, path).detach().numpy()
        diff = np.abs(got - want)
        assert diff.max() <= 0.1 * lr_sum and diff.mean() <= 1e-3 * lr_sum
    for tree_m, tree_r in ((s_mesh.opt.mu, s_ref.opt.mu),
                           (s_mesh.opt.nu, s_ref.opt.nu)):
        for path, st in _flat(tree_m):
            want = _get(tree_r, path).numpy()
            np.testing.assert_allclose(st.gather().numpy(), want, rtol=0,
                                       atol=GRAD_TOL * np.abs(want).max())
    assert int(s_mesh.step) == 2 and int(s_mesh.opt.count) == 2

    # the checkpoint holds the gathered JAX layout, file for file as the
    # unsharded run's
    ckpt.save(str(tmp_path / "mesh"), 2, s_mesh)
    ckpt.save(str(tmp_path / "flat"), 2, s_ref)
    man_m = ckpt._read_manifest(str(tmp_path / "mesh"), 2)
    man_f = ckpt._read_manifest(str(tmp_path / "flat"), 2)
    assert man_m["treedef"] == man_f["treedef"]
    assert man_m["dtypes"] == man_f["dtypes"]
    saved = ttree.leaves(ckpt._host_tree(s_mesh))

    def same(tree):
        for got, want in zip(ttree.leaves(tree), saved):
            got = got.gather() if isinstance(got, ShardedTensor) else got
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    # onto a (1, 1) mesh, onto no mesh, and through ElasticRunner
    one = LM(cfg, tp=1, mesh=mesh_from_devices(CPU4[:1], model=1),
             dtype=torch.float32, trainable=True)
    back = _restore_like(str(tmp_path / "mesh"), 2,
                         init_train_state(one.params))
    assert back.params["embed"].sharding.mesh.dims == (1, 1)
    same(back)
    flat = LM(cfg, tp=1, device="cpu", dtype=torch.float32, trainable=True)
    same(_restore_like(str(tmp_path / "mesh"), 2,
                       init_train_state(flat.params)))

    def shardings(mesh):
        p = LM(cfg, tp=mesh.shape["model"], mesh=mesh, device=None,
               dtype=torch.float32).param_shardings()
        return type(s_mesh)(params=p, opt=type(s_mesh.opt)(p, p, None),
                            step=None)
    runner = ElasticRunner(
        mesh_factory=lambda devs: mesh_from_devices(devs, model=1),
        shardings_factory=shardings, ckpt_dir=str(tmp_path / "mesh"))
    mesh, _, tree, extra = runner.recover(s_ref, CPU4[:2])
    assert mesh.dims == (2, 1) and extra["step"] == 2
    assert tree.params["embed"].sharding.mesh is mesh
    same(tree)


# -- (e) launchers and gaps ----------------------------------------------------


def test_launchers_run_on_a_host4_cpu_mesh(tmp_path, capsys):
    from repro_torch.launch import serve, train
    res = serve.run(device="cpu", mesh="host4", max_new=4)
    assert res["mesh"].dims == (2, 2) and res["lm"].tp == 2
    assert tuple(res["out"].shape) == (8, 4)
    assert "qwen1.5-4b-smoke" in res["line"]
    out = train.run(device="cpu", mesh="host4", steps=2,
                    ckpt_dir=str(tmp_path), ckpt_every=1, seq=16)
    assert int(out["state"].step) == 2 and len(out["losses"]) == 2
    assert isinstance(out["lm"].params["embed"], ShardedTensor)
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert mesh_from_flag("host3", "cpu").dims == (1, 2)
    with pytest.raises(ValueError, match="host<N>"):
        mesh_from_flag("hostx", "cpu")
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh()


def test_gaps_raise_naming_7f_ii():
    """Items 7f-ii and 7f-iii are done: every family serves on a mesh
    (moe, and the ssm / hybrid / encdec families: prefill, init_cache,
    decode_step, loss in value), and a decode cache whose spec shards its
    length builds and runs.  Item 7g is done too: every family's train
    step runs on the mesh (their parity:
    ``tests/test_torch_lm_mesh_train*.py``)."""
    mesh = mesh_from_devices(CPU4, model=2)
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int32),
             "targets": torch.zeros((4, 8), dtype=torch.int32)}
    for arch in ("llama4-scout-17b-a16e", "mamba2-130m", "zamba2-2.7b",
                 "seamless-m4t-large-v2"):
        other = LM(reduced(get_config(arch)), tp=2, mesh=mesh,
                   dtype=torch.float32, trainable=True)
        other.init(torch.Generator().manual_seed(0))
        assert isinstance(other.params["embed"], ShardedTensor)
        inputs = dict(batch)
        if other.cfg.family == "encdec":
            inputs["frames"] = torch.ones((4, 2, other.cfg.d_model))
        loss, _ = other.loss(inputs)
        assert np.isfinite(float(loss))
        tok, _ = other.prefill(inputs)
        cache = other.init_cache(4, 16)
        assert all(isinstance(t, ShardedTensor) for t in ttree.leaves(cache))
        nxt, _ = other.decode_step(cache, batch["tokens"][:, :1], 0)
        assert tuple(tok.shape) == tuple(nxt.shape) == (4,)
        state, m = make_train_step(other, TrainHParams(warmup=0))(
            init_train_state(other.params), inputs)
        assert int(state.step) == 1 and np.isfinite(float(m["loss"]))
    # 2 KV heads on a 4-way model axis stay replicated, so a cache of
    # 1,024 positions shards its length over ``model``: it now builds
    dense = LM(reduced(get_config("tinyllama-1.1b")), tp=4,
               mesh=mesh_from_devices(CPU4, model=4), dtype=torch.float32)
    spec = dense.input_shardings(dataclasses.replace(
        SHAPES["decode_32k"], seq_len=1024, global_batch=4))["cache"]["k"]
    assert spec.spec[2] == "model"
    long = dense.init_cache(4, 1024)
    assert long["k"].sharding.spec == spec.spec
    assert long["k"].shards[0].shape == (2, 4, 256, 2, 16)
    assert dense.init_cache(4, 64)["k"].shards[0].shape == (2, 4, 64, 2, 16)
    with pytest.raises(ValueError, match="tp=2"):
        LM(reduced(get_config("qwen1.5-4b")), tp=1, mesh=mesh,
           dtype=torch.float32).prefill(batch)
