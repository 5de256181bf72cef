"""Port parity for LM training on the dense family: ``lm_token_stream``,
``ShardedLoader``, ``cosine_warmup``, AdamW, ``LM.loss`` with and
without remat, the microbatched train step, fault tolerance and the
training launcher, against the JAX package on the same inputs, on the
CPU.

The JAX side is ``LM(cfg, tp=1, remat=..., compute_dtype=float32)`` at
the reduced configs (``configs/reduce.py``); its parameter tree is
carried into an ``LM(trainable=True)`` by
``convert.lm_params_from_numpy``.  Inputs come from seeded numpy
generators.

Tolerances, with their reasons:

- the data pipeline and the checkpoint format: bitwise (numpy on both
  sides);
- ``cosine_warmup``: rtol 1e-6 (float32 ``cos`` of two libraries);
- AdamW on the same gradients: params, ``mu`` and ``nu`` rtol 1e-6,
  atol 1e-7 (float32 elementwise arithmetic in JAX's order; XLA may
  contract a multiply-add, and ``pow`` / ``sqrt`` of two libraries);
- float32 ``loss``: rtol 1e-5 (max seen 1.4e-7 relative); the
  gradient of every leaf: within 5e-4 of that leaf's largest JAX
  magnitude (max seen 3.7e-5 on the dense configs; XLA and torch sum
  the float32 products of the backward pass in another order);
- the train step: the moments ``mu`` / ``nu`` to the gradients'
  tolerance, ``grad_norm`` rtol 5e-4 (seen 4.6e-5), the other metrics
  rtol 1e-5; the parameters within a tenth of the summed learning rates
  at every entry and a thousandth of it on average — AdamW divides by
  ``√v``, so an entry whose gradient is tiny (large relative error)
  takes a normalized step that differs by a fraction of ``lr`` (seen:
  one entry of 32,768 off by 3.4e-5 at lr 1e-3).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.configs.reduce import reduced as jreduced
from repro.data import ShardedLoader as JShardedLoader
from repro.data import lm_token_stream as jlm_token_stream
from repro.models.model import LM as JLM
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.optim.adamw import adamw_update as jadamw_update
from repro.optim.schedule import cosine_warmup as jcosine_warmup
from repro.train.step import TrainHParams as JTrainHParams
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import checkpoint as ckpt
from repro_torch import tree as ttree
from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import ShardedLoader, lm_token_stream
from repro_torch.distributed import Mesh, ShardedTensor
from repro_torch.distributed.fault_tolerance import (ElasticRunner,
                                                     StragglerWatchdog,
                                                     run_with_recovery)
from repro_torch.models.model import LM
from repro_torch.optim import (AdamWConfig, OptState, adamw_init,
                               adamw_update, cosine_warmup, global_norm)
from repro_torch.train.step import (TrainHParams, TrainState,
                                    init_train_state, make_train_step)

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

DENSE = ["tinyllama-1.1b", "qwen1.5-4b", "qwen1.5-110b", "starcoder2-7b",
         "internvl2-26b"]
GRAD_TOL = 5e-4


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _pair(arch, *, remat=False, seed=1):
    """The JAX LM (float32) and a trainable port LM holding its weights."""
    jlm = JLM(jreduced(jget_config(arch)), tp=1, remat=remat,
              compute_dtype=jnp.float32)
    params = jlm.init(jax.random.key(seed))
    lm = LM(reduced(get_config(arch)), device="cpu", dtype=torch.float32,
            trainable=True, remat=remat)
    lm_params_from_numpy(jax.tree.map(np.asarray, params), lm)
    return jlm, params, lm


def _batch(cfg, rng, b=2, s=12):
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (b, s), np.int32)}
    if cfg.prefix_len:
        out["prefix"] = rng.normal(0, 1, (b, cfg.prefix_len, cfg.d_model)) \
            .astype(np.float32)
    return out


def _tensors(batch) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _grads_close(got_tree, want_tree) -> None:
    got, want = ttree.leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, dtype=np.float32)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())


# -- data --------------------------------------------------------------------


@pytest.mark.parametrize("n,vocab,seed,order", [
    (5_000, 100, 0, 2), (3_000, 32_000, 7, 2), (2_000, 50, 3, 3)])
def test_lm_token_stream_bitwise(n, vocab, seed, order):
    got = lm_token_stream(n, vocab, seed=seed, order=order)
    want = jlm_token_stream(n, vocab, seed=seed, order=order)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_loader_batches_resume_and_hosts_equal_jax():
    """The JAX package's loader cases — deterministic resume, host
    sharding — on the port, each batch bitwise equal to the JAX
    loader's."""
    stream = lm_token_stream(10_000, 100, seed=1)
    a = ShardedLoader(stream, global_batch=4, seq_len=16, seed=3)
    ja = JShardedLoader(stream, global_batch=4, seq_len=16, seed=3)
    for _ in range(5):
        for x, y in zip(next(a), next(ja)):
            np.testing.assert_array_equal(x, y)
    state = a.state_dict()
    assert state == ja.state_dict() == {"step": 5, "seed": 3}
    a.close()
    ja.close()
    b = ShardedLoader.resume(stream, state, global_batch=4, seq_len=16)
    c = JShardedLoader(stream, global_batch=4, seq_len=16, seed=3,
                       start_step=5)
    for x, y in zip(next(b), next(c)):
        np.testing.assert_array_equal(x, y)
    b.close()
    c.close()
    full = ShardedLoader(stream, global_batch=8, seq_len=16, seed=7)
    t_full, _ = next(full)
    full.close()
    parts = []
    for host in range(2):
        part = ShardedLoader(stream, global_batch=8, seq_len=16, seed=7,
                             host_id=host, n_hosts=2)
        jpart = JShardedLoader(stream, global_batch=8, seq_len=16, seed=7,
                               host_id=host, n_hosts=2)
        parts.append(next(part)[0])
        np.testing.assert_array_equal(parts[-1], next(jpart)[0])
        part.close()
        jpart.close()
    np.testing.assert_array_equal(np.concatenate(parts), t_full)
    with pytest.raises(ValueError, match="split over"):
        ShardedLoader(stream, global_batch=7, seq_len=16, n_hosts=2)


# -- schedule and optimizer --------------------------------------------------


def test_cosine_warmup_matches_jax():
    steps = np.arange(0, 130, dtype=np.int32)
    for kw in (dict(peak_lr=1.0, warmup=10, total=100),
               dict(peak_lr=3e-4, warmup=100, total=10_000),
               dict(peak_lr=1e-2, warmup=0, total=1, floor=0.2)):
        got = cosine_warmup(torch.as_tensor(steps), **kw)
        assert got.dtype == torch.float32
        want = jcosine_warmup(jnp.asarray(steps), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    lr = [float(cosine_warmup(torch.tensor(s, dtype=torch.int32),
                              peak_lr=1.0, warmup=10, total=100))
          for s in (0, 5, 10, 100)]
    assert lr[0] == 0.0 and lr[1] == 0.5
    assert lr[2] == pytest.approx(1.0, abs=1e-3)
    assert lr[3] == pytest.approx(0.1, abs=1e-3)


def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(0, 1, (6, 5)).astype(np.float32),
              "b": [rng.normal(0, 1, (5,)).astype(np.float32),
                    {"z": rng.normal(0, 1, (3, 2, 2)).astype(np.float32)}]}
    grads = [jax.tree.map(lambda p: rng.normal(0, s, p.shape)
                          .astype(np.float32), params)
             for s in (0.5, 3.0, 0.1)]
    return params, grads


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_jax(clip):
    """Three AdamW steps on the same numpy gradients (the first two
    clipped at ``clip=1``): params, ``mu``, ``nu``, ``count`` and
    ``grad_norm`` against JAX."""
    params, grads = _opt_trees(4)
    cfg, jcfg = AdamWConfig(clip_norm=clip), JAdamWConfig(clip_norm=clip)
    p = jax.tree.map(torch.tensor, params)
    jp = jax.tree.map(jnp.asarray, params)
    st, jst = adamw_init(p), jadamw_init(jp)
    assert st.count.dtype == torch.int32 and int(st.count) == 0
    for i, g in enumerate(grads):
        lr = np.float32(1e-2 * (i + 1))
        p, st, m = adamw_update(cfg, jax.tree.map(torch.tensor, g), st, p,
                                torch.tensor(lr))
        jp, jst, jm = jadamw_update(jcfg, jax.tree.map(jnp.asarray, g), jst,
                                    jp, jnp.float32(lr))
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for got, want in ((p, jp), (st.mu, jst.mu), (st.nu, jst.nu)):
            for x, y in zip(ttree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(_np(x), np.asarray(y), rtol=1e-6,
                                           atol=1e-7)
        assert int(st.count) == int(jst.count) == i + 1
    assert float(global_norm(jax.tree.map(torch.tensor, grads[1]))) == \
        pytest.approx(float(jax.tree.reduce(
            lambda a, x: a + float(jnp.sum(jnp.square(x))), grads[1], 0.0))
            ** 0.5, rel=1e-6)


def test_adamw_reduces_quadratic():
    cfg = AdamWConfig(weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, m = adamw_update(cfg, grads, state, params,
                                        torch.tensor(0.05))
    assert float(params["w"].abs().max()) < 0.1
    assert np.isfinite(float(m["grad_norm"]))


def test_grad_clipping():
    cfg = AdamWConfig(clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    state = adamw_init(params)
    g = {"w": torch.tensor([1e4, 0.0, 0.0])}
    _, state2, m = adamw_update(cfg, g, state, params, torch.tensor(1.0))
    assert float(m["grad_norm"]) > 1e3
    assert float(state2.mu["w"].abs().max()) <= 0.11   # clipped to ~0.1
    assert float(g["w"][0]) == 1e4                     # grads left as given


# -- loss and gradients ------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_jax(arch, remat):
    """``LM.loss`` and the float32 gradient of every leaf against
    ``jax.value_and_grad(lm.loss)`` (internvl2: the loss over token
    positions after its prefix); ``remat`` wraps each layer in
    ``torch.utils.checkpoint`` on the port and ``jax.checkpoint`` on
    JAX."""
    jlm, params, lm = _pair(arch, remat=remat)
    batch = _batch(lm.cfg, np.random.default_rng(2))
    (jloss, jm), jgrads = jax.value_and_grad(jlm.loss, has_aux=True)(
        params, jax.tree.map(jnp.asarray, batch))
    loss, m = lm.loss(_tensors(batch))
    loss.backward()
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    assert float(m["acc"]) == float(jm["acc"])
    assert m["loss"].requires_grad is False
    _grads_close(lm.grads, jgrads)


def test_padded_vocab_columns_get_no_gradient():
    """mamba2's vocabulary pads 50,280 → 50,432 (reduced: 512 → 512, so
    pad a dense one by hand): the ``-1e30`` columns carry no gradient."""
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              vocab_size=500)
    assert cfg.padded_vocab > cfg.vocab_size
    lm = LM(cfg, device="cpu", dtype=torch.float32, trainable=True)
    lm.init(torch.Generator().manual_seed(0))
    loss, _ = lm.loss(_tensors(_batch(cfg, np.random.default_rng(3))))
    loss.backward()
    assert float(lm.grads["lm_head"][:, cfg.vocab_size:].abs().max()) == 0
    assert float(lm.grads["lm_head"][:, :cfg.vocab_size].abs().max()) > 0


def test_storage_views_and_serving_dtypes():
    """``lm.params`` holds one tensor per JAX leaf; the per-layer
    parameters view it (a write through either shows in the other); a
    serving LM stores matrices in the compute dtype and needs no
    gradients; ``make_train_step`` refuses it."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    lm = LM(cfg, device="cpu", dtype=torch.bfloat16, trainable=True)
    wq = lm.params["layers"]["attn"]["wq"]
    assert wq.dtype == torch.float32 and wq.shape[0] == cfg.n_layers
    with torch.no_grad():
        wq.fill_(0.5)
        lm.layers[1].attn["wq"].fill_(2.0)
    assert float(wq[1].max()) == 2.0
    assert float(lm.layers[0].attn["wq"][0, 0, 0]) == 0.5
    assert lm.layers[1].attn["wq"].grad.data_ptr() == \
        lm.grads["layers"]["attn"]["wq"][1].data_ptr()
    serve = LM(cfg, device="cpu", dtype=torch.bfloat16)
    assert serve.grads is None
    assert serve.params["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert serve.params["layers"]["ln1"].dtype == torch.float32
    assert not any(p.requires_grad for p in serve.parameters())
    with pytest.raises(ValueError, match="trainable=True"):
        make_train_step(serve, TrainHParams())


# -- the train step ----------------------------------------------------------


def test_train_step_two_microbatches_matches_jax():
    """Two steps of the 2-microbatch step (gradient sums over the row
    slices, divided by 2; lr from the step count before its increment)
    against the jitted JAX step on the same weights and batches."""
    jlm, params, lm = _pair("tinyllama-1.1b", seed=3)
    jhp = JTrainHParams(peak_lr=1e-3, warmup=1, total_steps=10, n_micro=2,
                        adamw=JAdamWConfig(clip_norm=5.0))
    hp = TrainHParams(peak_lr=1e-3, warmup=1, total_steps=10, n_micro=2,
                      adamw=AdamWConfig(clip_norm=5.0))
    jstep = jax.jit(jmake_train_step(jlm.loss, jhp))
    step = make_train_step(lm, hp)
    jstate = jinit_train_state(params)
    state = init_train_state(lm.params)
    assert state.params is lm.params and state.step.dtype == torch.int32
    rng = np.random.default_rng(5)
    for _ in range(2):
        batch = _batch(lm.cfg, rng, b=4, s=10)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        assert sorted(m) == sorted(jm) == ["acc", "grad_norm", "loss", "lr"]
        for k in m:
            np.testing.assert_allclose(
                float(m[k]), float(jm[k]),
                rtol=GRAD_TOL if k == "grad_norm" else 1e-5)
    assert int(state.step) == int(jstate.step) == 2
    assert int(state.opt.count) == 2
    lr_sum = sum(float(cosine_warmup(torch.tensor(i), peak_lr=1e-3,
                                     warmup=1, total=10)) for i in range(2))
    for got, want in zip(ttree.leaves(state.params),
                         jax.tree.leaves(jstate.params)):
        diff = np.abs(_np(got) - np.asarray(want))
        assert diff.max() <= 0.1 * lr_sum and diff.mean() <= 1e-3 * lr_sum
    for moment, jmoment in ((state.opt.mu, jstate.opt.mu),
                            (state.opt.nu, jstate.opt.nu)):
        _grads_close(moment, jmoment)


def test_train_loss_decreases_tinyllama():
    """The JAX package's case (bf16 compute, 50 steps of 2 microbatches
    at peak lr 1e-2, clip 5) on the port."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    lm = LM(cfg, device="cpu", trainable=True, remat=False)
    lm.init(torch.Generator().manual_seed(0))
    hp = TrainHParams(peak_lr=1e-2, warmup=5, total_steps=80, n_micro=2,
                      adamw=AdamWConfig(clip_norm=5.0))
    step = make_train_step(lm, hp)
    state = init_train_state(lm.params)
    stream = lm_token_stream(50_000, cfg.vocab_size, seed=0)
    loader = ShardedLoader(stream, global_batch=8, seq_len=64)
    losses = []
    for _ in range(50):
        tokens, targets = next(loader)
        state, metrics = step(state, {"tokens": tokens, "targets": targets})
        losses.append(float(metrics["loss"]))
    loader.close()
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


# -- fault tolerance ---------------------------------------------------------


def test_run_with_recovery_restarts(tmp_path):
    """A step that crashes once resumes from the latest checkpoint."""
    crashed = {"done": False}

    def step(state, i):
        if i == 7 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("simulated node failure")
        return {"x": state["x"] + 1}

    out = run_with_recovery(step, {"x": torch.zeros(())}, n_steps=10,
                            ckpt_dir=str(tmp_path), ckpt_every=2,
                            deadline_s=60.0)
    assert float(out["x"]) == 10.0 and isinstance(out["x"], torch.Tensor)
    assert crashed["done"]
    assert ckpt.valid_steps(str(tmp_path)) == [0, 2, 4, 6, 8, 10]
    # a fresh run on that directory resumes at the last step and stops
    assert float(run_with_recovery(step, {"x": torch.zeros(())}, n_steps=10,
                                   ckpt_dir=str(tmp_path))["x"]) == 10.0
    with pytest.raises(RuntimeError, match="always"):
        run_with_recovery(lambda s, i: (_ for _ in ()).throw(
            RuntimeError("always")), {"x": torch.zeros(())}, n_steps=3,
            ckpt_dir=str(tmp_path / "b"), max_restarts=2)


def test_run_with_recovery_replays_a_step_failed_after_its_update(tmp_path):
    """A step that updates its state in place (as the port's train step
    does) and then fails, before any checkpoint of the loop, replays
    from the step-0 checkpoint and ends where an unbroken run ends."""
    def run(fail_at):
        failed = []

        def step(state, i):
            state["x"].mul_(2).add_(i)
            if i == fail_at and not failed:
                failed.append(i)
                raise RuntimeError("failed after the update")
            return state

        out = run_with_recovery(step, {"x": torch.ones(3)}, n_steps=5,
                                ckpt_dir=str(tmp_path / str(fail_at)),
                                ckpt_every=50, deadline_s=60.0)
        return out["x"], failed

    whole, _ = run(None)
    for at in (0, 1, 4):
        got, failed = run(at)
        assert failed == [at]
        assert torch.equal(got, whole), (at, got, whole)


def test_straggler_watchdog_flags_slow_step():
    seen = []
    w = StragglerWatchdog(deadline_s=0.05,
                          on_straggle=lambda s, dt: seen.append(s))
    assert w.step(0, lambda: time.sleep(0.12) or 5) == 5
    w.step(1, lambda: None)
    assert [s for s, _ in w.slow_steps] == [0] and seen == [0]


def test_elastic_runner_onto_cpu(tmp_path):
    """Restore a checkpoint onto a new device set — here ``[cpu]`` —
    through ``mesh_factory`` / ``shardings_factory``; no checkpoint →
    ``None``; no device list and no GPU → raises."""
    tree = {"w": torch.arange(16.0)}
    runner = ElasticRunner(mesh_factory=lambda devs: Mesh(tuple(devs)),
                           shardings_factory=lambda mesh: {
                               "w": mesh.devices[0]},
                           ckpt_dir=str(tmp_path))
    mesh, sh, restored, extra = runner.recover(tree, [torch.device("cpu")])
    assert restored is None and extra is None
    ckpt.save(str(tmp_path), 3, tree, extra={"note": "x"})
    mesh, sh, restored, extra = runner.recover(tree, [torch.device("cpu")])
    assert extra == {"step": 3, "note": "x"}
    assert mesh.devices == (torch.device("cpu"),)
    assert isinstance(restored["w"], torch.Tensor)
    assert torch.equal(restored["w"], torch.arange(16.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runner.recover(tree)


# -- the launcher ------------------------------------------------------------


def _launch(tmp_path, name, *extra):
    from repro_torch.launch.train import main
    return main(["--device", "cpu", "--steps", "6", "--seq", "16",
                 "--global-batch", "4", "--ckpt-every", "2",
                 "--ckpt-dir", str(tmp_path / name), *extra])


def test_train_launcher_on_cpu_resumes_and_jax_restores(tmp_path, capsys,
                                                        monkeypatch):
    """``launch.train.main`` on the CPU: a run killed once (a step raises)
    replays from its checkpoint and ends at the unbroken run's state
    (to 1e-6); its checkpoint is
    the JAX ``TrainState`` tree, which the JAX ``restore`` reads back
    bitwise; ``--n-micro 2`` runs; ``--mesh host8`` runs on a (4, 2) CPU
    mesh and checkpoints the gathered tree, which JAX reads back."""
    whole = _launch(tmp_path, "whole")
    assert "training complete; final step 6" in capsys.readouterr().out
    assert len(whole["losses"]) == 6 and all(np.isfinite(whole["losses"]))

    import repro_torch.train.step as step_mod
    real = step_mod.make_train_step
    crashed = []

    def crashing(lm, hp):
        inner = real(lm, hp)

        def train_step(state, batch):
            if int(state.step) == 3 and not crashed:
                crashed.append(True)
                raise RuntimeError("simulated node failure")
            return inner(state, batch)
        return train_step

    monkeypatch.setattr(step_mod, "make_train_step", crashing)
    killed = _launch(tmp_path, "killed")
    monkeypatch.setattr(step_mod, "make_train_step", real)
    assert crashed and len(killed["losses"]) == 7     # step 2 ran twice
    assert killed["losses"][2] == killed["losses"][3]
    # the CPU's matrix products may round by an ulp apart when their
    # buffers lie at other alignments (the card's gate 3 in chip_smoke.py
    # is bitwise)
    for a, b in zip(ttree.leaves(killed["state"]),
                    ttree.leaves(whole["state"])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-9)

    jlm = JLM(jreduced(jget_config("tinyllama-1.1b")), tp=1)
    like = jinit_train_state(jlm.init(jax.random.key(0)))
    jtree, _ = jckpt.restore(str(tmp_path / "whole"), 6, like)
    _, treedef = ckpt._tree_flatten(whole["state"])
    assert treedef == str(jax.tree.structure(like))
    for a, b in zip(ttree.leaves(whole["state"]), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))

    micro = _launch(tmp_path, "micro", "--n-micro", "2")
    assert int(micro["state"].step) == 6
    # --mesh host8: a (4, 2) mesh of the CPU, tp 2; its checkpoint is
    # the gathered JAX tree, which the JAX restore reads back bitwise
    meshed = _launch(tmp_path, "mesh", "--mesh", "host8")
    assert meshed["mesh"].dims == (4, 2) and int(meshed["state"].step) == 6
    jlm2 = JLM(jreduced(jget_config("tinyllama-1.1b")), tp=2)
    like2 = jinit_train_state(jlm2.init(jax.random.key(0)))
    jtree2, _ = jckpt.restore(str(tmp_path / "mesh"), 6, like2)
    for a, b in zip(ttree.leaves(meshed["state"]), jax.tree.leaves(jtree2)):
        a = a.gather() if isinstance(a, ShardedTensor) else a
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def test_train_launcher_replays_a_step_failed_after_its_update(
        tmp_path, monkeypatch):
    """A step that fails after the train step has updated parameters and
    moments in place (where the launcher's ``float(loss)`` would surface
    an asynchronous device error), before the first ``--ckpt-every``
    checkpoint, replays from the step-0 checkpoint and ends at the
    unbroken run's state (to 1e-6, as above)."""
    import repro_torch.train.step as step_mod
    whole = _launch(tmp_path, "whole", "--ckpt-every", "50")
    real = step_mod.make_train_step
    crashed = []

    def crashing(lm, hp):
        inner = real(lm, hp)

        def train_step(state, batch):
            out = inner(state, batch)
            if int(out[0].step) == 2 and not crashed:
                crashed.append(True)
                raise RuntimeError("simulated device error")
            return out
        return train_step

    monkeypatch.setattr(step_mod, "make_train_step", crashing)
    killed = _launch(tmp_path, "killed", "--ckpt-every", "50")
    assert crashed and len(killed["losses"]) == 6 + 1
    assert ckpt.valid_steps(str(tmp_path / "killed")) == [0, 6]
    for a, b in zip(ttree.leaves(killed["state"]),
                    ttree.leaves(whole["state"])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-9)


def test_train_state_is_a_checkpointable_tree(tmp_path):
    """``TrainState`` / ``OptState`` flatten as JAX's NamedTuples: a
    JAX-written state restores into the port's structure bitwise."""
    jlm, params, lm = _pair("qwen1.5-4b")
    jstate = jinit_train_state(params)
    jstate = jstate._replace(step=jnp.int32(7))
    jckpt.save(str(tmp_path), 7, jstate)
    state = init_train_state(lm.params)
    assert isinstance(state, TrainState) and isinstance(state.opt, OptState)
    got, _ = ckpt.restore(str(tmp_path), 7, state)
    assert isinstance(got, TrainState) and isinstance(got.opt, OptState)
    assert int(got.step) == 7
    for a, b in zip(ttree.leaves(got), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
