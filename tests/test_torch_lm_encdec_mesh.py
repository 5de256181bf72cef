"""Port parity for the ``encdec`` family on a device mesh
(``models/sharded.py``'s encoder and decoder units: seamless-m4t-large-v2's
bidirectional encoder over ``frames``, the decoder's self- and
cross-attention, the ``xk`` / ``xv`` cache), against the JAX package on
the CPU.

The JAX side is ``LM(cfg, tp=1, remat=False, compute_dtype=float32)``
unsharded, at the reduced config (``configs/reduce.py``); its tree is
carried into a sharded port ``LM`` by ``convert.lm_params_from_numpy``.
At the reduced width the JAX trees at ``tp`` 1, 2 and 4 are one tree (4
query and 4 KV heads need no padding; asserted leaf by leaf).  The
port's meshes list the CPU four times (``[cpu] * 4``): (2, 2), (1, 4)
and (4, 1).  Tokens, ``frames`` and random decode caches come from
seeded numpy generators.

A decode step reads the cache's ``xk`` / ``xv`` under their spec and
never writes them (ROADMAP.md, R6: the reference's ``generate`` takes no
``frames`` and decodes over a zero cross-attention cache); a batch of 1
with a 1,024-position cache splits the self-attention cache's length
over ``data``, and at 4,096 positions ``xk`` / ``xv`` (1,024 positions)
split theirs too (sequence-parallel cross-attention).

Tolerances, with their reasons (``tests/test_torch_lm_moe_mesh.py``'s):

- float32 logits, caches (k, v, xk, xv) and the loss: rtol 1e-4 and an
  absolute 1e-4 of the compared tensor's largest magnitude (at least
  1e-4) (XLA and torch sum float32 products in another order; the mesh
  adds the partial sums over ``model`` in member order);
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
from repro.models.model import LM as JLM
from repro.serve.decode import generate as jgenerate
from repro_torch import tree as ttree
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.configs.reduce import reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed.sharding import Mesh, ShardedTensor
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import mesh_from_devices
from repro_torch.models.model import LM
from repro_torch.serve.decode import generate
from repro_torch.train.step import (TrainHParams, init_train_state,
                                    make_train_step)

# one xdist worker per core runs these files beside the JAX suite
torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
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


@pytest.fixture(scope="module")
def jax_lm():
    jlm = JLM(jreduced(jget_config(ARCH)), tp=1, remat=False,
              compute_dtype=jnp.float32)
    params = jlm.init(jax.random.key(7))
    return jlm, params, jax.tree.map(np.asarray, params)


def _mesh_lm(dims, tree, dtype=torch.float32):
    data, model = dims
    mesh = mesh_from_devices(CPU4, model=model)
    assert mesh.dims == dims
    lm = LM(reduced(get_config(ARCH)), tp=model, mesh=mesh, dtype=dtype)
    for path, st in _flat(lm.params):     # one tree serves every tp
        assert st.shape == np.shape(_get(tree, path)), path
    lm_params_from_numpy(tree, lm)
    return lm


@pytest.fixture(scope="module")
def ref(jax_lm):
    """The JAX LM's float32 outputs on one batch with frames: every
    position's logits, the prefill token and cache, 4 decode steps from
    a cache of 12 (tokens and caches), the loss and a ``generate``."""
    jlm, params, tree = jax_lm
    cfg = jlm.cfg
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 8), np.int32)
             for k in ("tokens", "targets")}
    batch["frames"] = rng.normal(
        0, 1, (4, 8 // cfg.enc_len_ratio, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    h, _ = jax.jit(lambda p, t, f: jlm._forward(p, t, frames=f))(
        params, jb["tokens"], jb["frames"])
    logits = np.asarray(jlm._logits(params, h))
    jtok, jcache = jax.jit(jlm.prefill)(
        params, {"tokens": jb["tokens"], "frames": jb["frames"]})
    step = jax.jit(jlm.decode_step)
    dcache, steps = jlm.init_cache(4, 12), []
    for pos in range(4):
        t, dcache = step(params, dcache, jb["tokens"][:, pos:pos + 1],
                         jnp.int32(pos))
        steps.append(np.asarray(t))
    loss, _ = jax.jit(jlm.loss)(params, jb)
    gen = jax.jit(lambda p, t: jgenerate(jlm, p, t, max_new=4))(
        params, jb["tokens"][:, :5])
    return {"tree": tree, "batch": batch, "logits": logits,
            "tok": np.asarray(jtok),
            "prefill_cache": [np.asarray(x) for x in jax.tree.leaves(jcache)],
            "steps": steps,
            "decode_cache": [np.asarray(x) for x in jax.tree.leaves(dcache)],
            "loss": float(loss), "generate": np.asarray(gen)}


@pytest.mark.parametrize("dims", MESH_DIMS, ids=lambda d: f"{d[0]}x{d[1]}")
def test_encdec_mesh_matches_jax(ref, dims):
    """Prefill logits over ``frames``, next token and cache ((k, v), (xk,
    xv) of every decoder layer), 4 decode steps (tokens and the gathered
    cache, ``xk`` / ``xv`` still zero) and the ``loss`` value on the CPU
    mesh, against the unsharded JAX LM on the same weights."""
    lm = _mesh_lm(dims, ref["tree"])
    tb = {k: torch.as_tensor(v) for k, v in ref["batch"].items()}
    inputs = {"tokens": tb["tokens"], "frames": tb["frames"]}
    _close(lm._mesh_exec().logits(inputs), ref["logits"])
    tok, cache = lm.prefill(inputs)
    _tokens_agree(tok, ref["tok"], ref["logits"][:, -1])
    (kv, xkv) = cache
    assert all(isinstance(t, ShardedTensor) for t in (*kv, *xkv))
    if dims[1] > 1:       # the cross keys' heads split over model
        assert xkv[0].sharding.spec[3] == "model"
    for got, want in zip(_gathered(cache), ref["prefill_cache"], strict=True):
        _close(got, want)
    pc = lm.init_cache(4, 12)
    assert all(isinstance(t, ShardedTensor) for t in ttree.leaves(pc))
    for pos, want in enumerate(ref["steps"]):
        nxt, pc = lm.decode_step(pc, tb["tokens"][:, pos:pos + 1], pos)
        np.testing.assert_array_equal(nxt.numpy(), want)
    for got, want in zip(_gathered(pc), ref["decode_cache"], strict=True):
        _close(got, want)
    assert not pc["xk"].gather().any() and not pc["xv"].gather().any()
    loss, _ = lm.loss(tb)
    _close(loss, ref["loss"])


@pytest.mark.parametrize("dims", [(2, 2), (1, 4)],
                         ids=lambda d: f"{d[0]}x{d[1]}")
def test_r6_mesh_generate_equals_the_unsharded_port_and_jax(ref, dims):
    """ROADMAP.md, R6, on the mesh: ``generate`` (no ``frames``; the
    cross-attention reads a zero ``xk`` / ``xv``) gives the unsharded
    port's tokens and JAX's."""
    lm = _mesh_lm(dims, ref["tree"])
    flat = LM(reduced(get_config(ARCH)), tp=1, device="cpu",
              dtype=torch.float32)
    lm_params_from_numpy(ref["tree"], flat)
    prompt = torch.as_tensor(ref["batch"]["tokens"][:, :5])
    got = generate(lm, prompt, max_new=4)
    np.testing.assert_array_equal(got.numpy(),
                                  generate(flat, prompt, max_new=4).numpy())
    np.testing.assert_array_equal(got.numpy(), ref["generate"])


# (mesh, cache positions, decode positions, whether xk / xv split their
# length): a batch of 1 cannot split over 2 data members, so at 1,024
# positions the self-attention cache's length goes over data; at 4,096
# the cross cache's 1,024 positions do too
LONG_CASES = {
    "2x2-1024": ((2, 2), 1024, (255, 511, 512, 1023, 1030), False),
    "4x1-1024": ((4, 1), 1024, (255, 256, 700, 1023), False),
    "2x2-4096": ((2, 2), 4096, (5, 2047, 2048, 4000), True),
}


@pytest.mark.parametrize("case", list(LONG_CASES))
def test_b1_long_cache_runs_sequence_parallel(jax_lm, case):
    """Decode steps at a batch of 1 from a random cache (random ``xk`` /
    ``xv`` included, so the cross-attention reads real keys) at positions
    across the members' length slices give JAX's tokens and caches;
    ``xk`` / ``xv`` are read, never written."""
    dims, cache_len, positions, cross_split = LONG_CASES[case]
    jlm, params, tree = jax_lm
    jcache = jlm.init_cache(1, cache_len)
    rng = np.random.default_rng(50 + list(LONG_CASES).index(case))
    filled = [rng.normal(0, 1, np.shape(x)).astype(np.float32)
              for x in jax.tree.leaves(jcache)]
    jcache = jax.tree.unflatten(jax.tree.structure(jcache),
                                [jnp.asarray(x) for x in filled])
    lm = _mesh_lm(dims, tree)
    pc = lm.init_cache(1, cache_len)
    spec = lm.input_shardings(ShapeSpec("c", cache_len, 1,
                                        "decode"))["cache"]
    for path, st in _flat(pc):
        assert st.sharding.spec == _get(spec, path).spec
    assert pc["k"].sharding.spec[2] == "data"
    assert (pc["xk"].sharding.spec[2] == "data") == cross_split
    for t, full in zip(ttree.leaves(pc), filled, strict=True):
        t.copy_(torch.as_tensor(full))
    xk0 = pc["xk"].gather().clone()
    toks = rng.integers(0, lm.cfg.vocab_size, (len(positions), 1, 1),
                        np.int32)
    step = jax.jit(jlm.decode_step)
    for pos, tok in zip(positions, toks):
        want, jcache = step(params, jcache, jnp.asarray(tok), jnp.int32(pos))
        got, pc = lm.decode_step(pc, torch.as_tensor(tok), pos)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"position {pos}")
    for got, want in zip(_gathered(pc), jax.tree.leaves(jcache),
                         strict=True):
        _close(got, want)
    assert torch.equal(pc["xk"].gather(), xk0)


def test_member_bytes_equal_the_dryrun_arguments():
    """Every member of a bfloat16 serving LM on the (2, 2) mesh holds its
    parameter shards (the encoder's included), decode-cache shards (k, v,
    xk, xv) and token rows: the port dry-run's argument bytes for the
    decode cell on a (2, 2) meta mesh, to the byte, at (8, 64) and at a
    batch of 1 with 1,024 positions (the self-attention length over
    ``data``)."""
    cfg = reduced(get_config(ARCH))
    lm = LM(cfg, tp=2, mesh=mesh_from_devices(CPU4, model=2),
            dtype=torch.bfloat16)
    meta = Mesh((torch.device("meta"),) * 4, ("data", "model"), (2, 2))
    for b, cache_len in ((8, 64), (1, 1024)):
        cache = lm.init_cache(b, cache_len)
        rows = lm._mesh_exec()._rows(b)
        stored = []
        for k in range(4):
            n = sum(t.nbytes(k) for t in ttree.leaves(lm.params))
            n += sum(t.nbytes(k) for t in ttree.leaves(cache))
            stored.append(n + len(range(b)[rows[k]]) * 4)
        rec = dryrun.run_cell(ARCH, "serve", False, roofline=False, cfg=cfg,
                              mesh=meta,
                              shape=ShapeSpec("serve", cache_len, b,
                                              "decode"))
        assert stored == [rec["memory"]["bytes"]["argument"]] * 4


def test_serve_launcher_runs_encdec_on_a_host4_cpu_mesh():
    """``launch.serve.run(mesh="host4")``: a (2, 2) mesh, tp 2, decoding
    without ``frames`` (R6); also at a batch of 1 into a 1,024-position
    cache."""
    from repro_torch.launch.serve import run
    for kw in ({"batch": 2}, {"batch": 1, "cache_len": 1024}):
        res = run(ARCH, prompt_len=5, max_new=3, device="cpu", mesh="host4",
                  **kw)
        assert res["mesh"].dims == (2, 2) and res["lm"].tp == 2
        out = res["out"]
        assert tuple(out.shape) == (kw["batch"], 3)
        assert 0 <= int(out.min()) and int(out.max()) < res["cfg"].vocab_size


def test_train_step_on_a_mesh_names_7g_and_the_dryrun_counts_serving():
    """Item 7g is done: a train step of the encdec family runs on a (2, 2)
    mesh with ``frames`` (its parity: ``tests/test_torch_lm_mesh_train_ssm.py``),
    and every cell of the dry-run reports collective bytes (no mesh gap):
    the encoder's and cross-attention's partial sums among them, and for
    the train cell the remat recompute and the backward pass besides."""
    cfg = reduced(get_config(ARCH))
    lm = LM(cfg, tp=2, mesh=mesh_from_devices(CPU4, model=2),
            dtype=torch.float32, trainable=True)
    lm.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 8), np.int32)
             for k in ("tokens", "targets")}
    batch["frames"] = rng.normal(0, 1, (4, 2, cfg.d_model)).astype(np.float32)
    step = make_train_step(lm, TrainHParams(peak_lr=1e-3, warmup=0))
    state, m = step(init_train_state(lm.params), batch)
    assert int(state.step) == 1 and np.isfinite(float(m["loss"]))
    assert float(m["grad_norm"]) > 0
    meta = Mesh((torch.device("meta"),) * 4, ("data", "model"), (2, 2))
    got = {}
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = dataclasses.replace(SHAPES[name], seq_len=64, global_batch=8)
        rec = dryrun.run_cell(ARCH, name, False, cfg=cfg, shape=shape,
                              mesh=meta)
        got[name] = rec["per_device"]["collective_bytes"]
        assert "mesh_gap" not in rec and got[name] > 0
    assert got["train_4k"] > got["prefill_32k"]
    # prefill: per member 4 rows of 64 positions, tp 2, bf16: each of the
    # 2 encoder layers' 2 partial sums over 16 frames, each of the 2
    # decoder layers' 3 over 64 positions
    row = 4 * 2 * cfg.d_model
    assert got["prefill_32k"] >= row * (2 * 2 * 16 + 2 * 3 * 64)
    assert 0 < got["decode_32k"] < got["prefill_32k"]
