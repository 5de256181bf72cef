"""Port parity for training the moe family on a device mesh
(``models/sharded.py``'s backward pass: llama4-scout and deepseek-v2's
routed-expert units, MLA, the vocabulary-split loss) against the JAX
package on the CPU.  ``tests/test_torch_lm_mesh_train_ssm.py`` holds the
ssm, hybrid and encdec families to the same bounds.

The JAX side is ``LM(cfg, tp=1, remat=False, compute_dtype=float32)``
unsharded at the reduced configs (``configs/reduce.py``): its
``value_and_grad(loss)``.  At the reduced widths the JAX trees at ``tp``
1, 2 and 4 are one tree (asserted), so one JAX model serves every mesh.
Its tree is carried into a sharded port ``LM(trainable=True)`` on the
meshes (2, 2), (1, 4) and (4, 1) of the CPU listed four times, by
``convert.lm_params_from_numpy``.  Inputs come from seeded numpy
generators.

Tolerances, with their reasons (stated before the first reading):

- ``loss``: rtol 1e-5 (the mesh sums each data shard's token losses,
  then the shards, in fixed order);
- every gathered gradient leaf within ``GRAD_TOL[arch]`` of that leaf's
  largest JAX magnitude, the unsharded tests' bounds: llama4 2e-3
  (JAX's own 1e-7 parameter perturbation moves its gradients that far,
  ``tests/test_torch_lm_moe_train.py``), deepseek 5e-4 (the others in
  ``tests/test_torch_lm_mesh_train_ssm.py``); llama4's routers
  (R9) ``|g| <= 1e-6`` on both packages; the meshes' gathered gradients
  within the same bound of each other; after ``reduce_grads`` the copies
  of a replicated slice are equal;
- two backward passes on the same inputs: bitwise (every cross-member
  sum runs in fixed member order);
- routing: the moe tests' stated precondition (no token's k-th and
  (k+1)-th gates within 1e-5), checked on the unsharded port, which
  routes the same global tokens;
- two train steps on (2, 2) against the unsharded port, both at
  learning rate 1e-3 (warmup 0), at the bounds of
  ``tests/test_torch_lm_sharding.py``'s dense case: ``loss`` rtol 1e-5
  and ``grad_norm`` rtol 5e-4 at each step; after the second, the
  parameters within a tenth of the summed learning rates at every entry
  and a thousandth of it on average, the moments within ``GRAD_TOL`` of
  their largest entry; llama4's routers as R9 (moments within 1e-6 /
  1e-12 absolute, the parameters within twice the summed learning
  rates).  For the ``RESYNC`` models the unsharded run takes the mesh's
  parameters and moments before the second step, which is then held
  from equal state (the summed rate is that step's) and its gradients
  at ``GRAD_TOL``: after a step that moves the parameters, AdamW's
  normalized update parts the two runs by up to a tenth of ``lr`` an
  entry, and the next step's gradients move with it (set after a
  reading on the CPU: chained, llama4's ``w2`` gradients parted 3.1e-3
  of their largest entry, deepseek's ``embed`` second moment 1.27× its
  bound, zamba2's ``grad_norm`` 6.2e-4; mamba2 and seamless hold the
  bounds chained).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.reduce import reduced as jreduced
from repro.models.model import LM as JLM
from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed.sharding import ShardedTensor
from repro_torch.launch.mesh import mesh_from_devices
from repro_torch.models import moe
from repro_torch.models.model import LM
from repro_torch.train.step import (TrainHParams, init_train_state,
                                    make_train_step)

# one xdist worker per core runs these files beside the JAX suite
torch.set_num_threads(2)

LLAMA4, DEEPSEEK = "llama4-scout-17b-a16e", "deepseek-v2-236b"
ARCHS = [LLAMA4, DEEPSEEK]
# every non-dense family, for this file and the ssm / hybrid / encdec one
ALL = [LLAMA4, DEEPSEEK, "mamba2-130m", "zamba2-2.7b",
       "seamless-m4t-large-v2"]
GRAD_TOL = {a: {LLAMA4: 2e-3, "zamba2-2.7b": 1e-3}.get(a, 5e-4) for a in ALL}
MESH_DIMS = [(2, 2), (1, 4), (4, 1)]
R9_ABS = 1e-6
# the models whose unsharded run takes the mesh's state before the second
# train step (the module docstring)
RESYNC = (LLAMA4, DEEPSEEK, "zamba2-2.7b")
GATE_GAP = 1e-5
CPU4 = [torch.device("cpu")] * 4


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
    if isinstance(t, ShardedTensor):
        t = t.gather()
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _np_tree(tree) -> dict:
    return {k: _np_tree(v) if isinstance(v, dict) else _np(v)
            for k, v in tree.items()}


def _r9(arch, path) -> bool:
    return arch == LLAMA4 and path[-1] == "router"


def _batch(cfg, rng, b=4, s=20):
    out = {k: rng.integers(0, cfg.vocab_size, (b, s), np.int32)
           for k in ("tokens", "targets")}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(0, 1, (b, s // cfg.enc_len_ratio,
                                          cfg.d_model)).astype(np.float32)
    return out


def _tensors(batch) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _mesh_lm(arch, dims, tree, remat=False):
    mesh = mesh_from_devices(CPU4, model=dims[1])
    assert mesh.dims == dims
    lm = LM(reduced(get_config(arch)), tp=dims[1], mesh=mesh,
            dtype=torch.float32, trainable=True, remat=remat)
    for path, st in _flat(lm.params):     # one tree serves every tp
        assert st.shape == np.shape(_get(tree, path)), path
    lm_params_from_numpy(tree, lm)
    return lm


def _grads(lm, batch):
    """``loss`` and its backward on the mesh → (loss, acc, the gathered
    gradient tree as numpy)."""
    loss, m = lm.loss(_tensors(batch))
    loss.backward()
    lm.reduce_grads()
    for _, g in _flat(lm.grads):        # replicated copies agree
        full = g.gather()
        for k, t in enumerate(g.shards):
            np.testing.assert_array_equal(
                t.numpy(), full[g.sharding.member_index(k, g.shape)].numpy())
    got = {}
    for path, g in _flat(lm.grads):
        node = got
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g.gather().numpy()
    return float(loss.detach()), float(m["acc"]), got


def _held(arch, got, want, what) -> None:
    for path, w in _flat(want):
        w = np.asarray(w, dtype=np.float32)
        g = np.asarray(_get(got, path))
        if _r9(arch, path):
            assert np.abs(w).max() <= R9_ABS and np.abs(g).max() <= R9_ABS
            continue
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL[arch] * np.abs(w).max(),
                                   err_msg=f"{what}: {'/'.join(path)}")


def _gate_gaps(arch, tree, batch) -> float:
    """The smallest k-th to (k+1)-th gate gap of every routing the
    unsharded port runs on ``batch`` (∞ without routed experts)."""
    cfg = reduced(get_config(arch))
    if not cfg.n_experts:
        return float("inf")
    lm = LM(cfg, device="cpu", dtype=torch.float32)
    lm_params_from_numpy(tree, lm)
    gaps, real = [], moe.moe_route

    def watch(c, router, xt):
        r = real(c, router, xt)
        s = torch.sort(r.gates, -1, descending=True).values
        gaps.append(float((s[:, c.top_k - 1] - s[:, c.top_k]).min()))
        return r
    moe.moe_route = watch
    try:
        with torch.no_grad():
            lm.loss(_tensors(batch))
    finally:
        moe.moe_route = real
    return min(gaps)


def reference(arch):
    """One arch's JAX tree, batch and unsharded float32 ``value_and_grad``
    of ``loss``."""
    jlm = JLM(jreduced(jget_config(arch)), tp=1, remat=False,
              compute_dtype=jnp.float32)
    params = jlm.init(jax.random.key(1))
    tree = jax.tree.map(np.asarray, params)
    batch = _batch(jlm.cfg, np.random.default_rng(8 + ALL.index(arch)))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    gap = _gate_gaps(arch, tree, batch)
    assert gap > GATE_GAP, f"a top-k near-tie ({gap:.2e}) in the inputs"
    return arch, tree, batch, float(jloss), float(jm["acc"]), \
        jax.tree.map(np.asarray, jgrads)


def check_mesh_grads(ref, dims, remat):
    """``loss`` and every gathered gradient leaf on the mesh against the
    unsharded JAX ``value_and_grad``; ``remat`` checkpoints every unit."""
    arch, tree, batch, jloss, jacc, jgrads = ref
    lm = _mesh_lm(arch, dims, tree, remat=remat)
    loss, acc, got = _grads(lm, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert acc == pytest.approx(jacc)
    _held(arch, got, jgrads, f"{dims}")


def check_meshes_agree_and_bitwise(ref):
    """The three meshes' gradients lie within the bound of each other, and
    a second backward pass on (2, 2) (rematted) repeats the first bit for
    bit."""
    arch, tree, batch, *_ = ref
    grads = [_grads(_mesh_lm(arch, d, tree), batch)[2] for d in MESH_DIMS]
    for d, g in zip(MESH_DIMS[1:], grads[1:]):
        _held(arch, g, grads[0], f"{d} against (2, 2)")
    lm = _mesh_lm(arch, (2, 2), tree, remat=True)
    first = _grads(lm, batch)[2]
    for _, g in _flat(lm.grads):
        g.map(torch.zero_)
    second = _grads(lm, batch)[2]
    for path, w in _flat(first):
        np.testing.assert_array_equal(_get(second, path), w,
                                      err_msg="/".join(path))


def _unsharded(arch, tree):
    lm = LM(reduced(get_config(arch)), device="cpu", dtype=torch.float32,
            trainable=True)
    lm_params_from_numpy(tree, lm)
    return lm


def _resync(s_ref, s_mesh) -> None:
    """The unsharded state takes the mesh's parameters and moments."""
    with torch.no_grad():
        for tr, tm in ((s_ref.params, s_mesh.params),
                       (s_ref.opt.mu, s_mesh.opt.mu),
                       (s_ref.opt.nu, s_mesh.opt.nu)):
            for path, st in _flat(tm):
                _get(tr, path).copy_(st.gather())


def _held_state(arch, s_mesh, s_ref, lr_sum) -> None:
    """Parameters within a tenth of the summed learning rates at every
    entry and a thousandth on average, moments within ``GRAD_TOL`` of
    their largest entry (R9's routers as the module docstring says)."""
    for path, st in _flat(s_mesh.params):
        diff = np.abs(_np(st) - _np(_get(s_ref.params, path)))
        bound = 2 * lr_sum if _r9(arch, path) else 0.1 * lr_sum
        assert diff.max() <= bound, path
        if not _r9(arch, path):
            assert diff.mean() <= 1e-3 * lr_sum, path
    for tree_m, tree_r, r9 in ((s_mesh.opt.mu, s_ref.opt.mu, R9_ABS),
                               (s_mesh.opt.nu, s_ref.opt.nu, R9_ABS ** 2)):
        for path, st in _flat(tree_m):
            got, want = _np(st), _np(_get(tree_r, path))
            if _r9(arch, path):
                assert np.abs(got).max() <= r9 and np.abs(want).max() <= r9
                continue
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=GRAD_TOL[arch] *
                                       np.abs(want).max(),
                                       err_msg="/".join(path))


def _resync(s_ref, s_mesh) -> None:
    """The unsharded state takes the mesh's parameters and moments."""
    with torch.no_grad():
        for tr, tm in ((s_ref.params, s_mesh.params),
                       (s_ref.opt.mu, s_mesh.opt.mu),
                       (s_ref.opt.nu, s_mesh.opt.nu)):
            for path, st in _flat(tm):
                _get(tr, path).copy_(st.gather())


def check_two_train_steps(ref):
    """``make_train_step`` on the (2, 2) mesh (remat on, 2 microbatches)
    against the unsharded port on the same weights and batches, both steps
    at learning rate, the state held after the second; for the ``RESYNC``
    models the unsharded run takes the mesh's parameters and moments
    before the second step, whose gradients are then held at equal
    parameters."""
    arch, tree, *_ = ref
    flat, lm = _unsharded(arch, tree), _mesh_lm(arch, (2, 2), tree,
                                                remat=True)
    hp = TrainHParams(peak_lr=1e-3, warmup=0, total_steps=10, n_micro=2)
    s_ref, s_mesh = init_train_state(flat.params), init_train_state(lm.params)
    step_ref, step_mesh = make_train_step(flat, hp), make_train_step(lm, hp)
    rng = np.random.default_rng(11)
    lr_sum = 0.0
    for i in range(2):
        batch = _batch(lm.cfg, rng, b=8, s=12)
        if i and arch in RESYNC:
            _resync(s_ref, s_mesh)
            lr_sum = 0.0
        s_ref, m_ref = step_ref(s_ref, batch)
        s_mesh, m_mesh = step_mesh(s_mesh, batch)
        lr_sum += float(m_ref["lr"])
        np.testing.assert_allclose(float(m_mesh["loss"]),
                                   float(m_ref["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m_mesh["grad_norm"]),
                                   float(m_ref["grad_norm"]), rtol=5e-4)
    assert int(s_mesh.step) == 2 and int(s_mesh.opt.count) == 2
    _held_state(arch, s_mesh, s_ref, lr_sum)
    if arch in RESYNC:
        _held(arch, _np_tree(lm.grads), _np_tree(flat.grads),
              "the second step")


def check_train_launcher(arch, tmp_path):
    """``launch.train.run(mesh="host4")`` at reduced width: a (2, 2) mesh,
    tp 2, finite losses, sharded parameters, a checkpoint per step."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.train import run
    out = run(arch, steps=2, seq=16, device="cpu", mesh="host4",
              ckpt_dir=str(tmp_path), ckpt_every=1)
    assert out["mesh"].dims == (2, 2) and out["lm"].tp == 2
    assert int(out["state"].step) == 2 and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
    assert isinstance(out["lm"].params["embed"], ShardedTensor)
    assert latest_step(str(tmp_path)) == 2


# -- the moe family ---------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return reference(request.param)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("dims", MESH_DIMS, ids=lambda d: f"{d[0]}x{d[1]}")
def test_mesh_loss_and_grads_match_jax(ref, dims, remat):
    check_mesh_grads(ref, dims, remat)


def test_meshes_agree_and_two_backward_passes_are_bitwise(ref):
    check_meshes_agree_and_bitwise(ref)


def test_two_train_steps_on_2x2_match_the_unsharded_port(ref):
    check_two_train_steps(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_on_a_host4_cpu_mesh(arch, tmp_path):
    check_train_launcher(arch, tmp_path)
