"""Port parity for training the ssm, hybrid and encdec families on a
device mesh (``models/sharded.py``'s backward pass: the mamba unit's
``in_proj`` block gather, per-channel leaves gathered whole, the ``P``
slice of the SSD scan, the norm's sum of squares and ``out_proj``'s row
blocks; zamba2's shared block, whose gradient sums its sites; seamless's
encoder units and cross-attention, with ``frames``), against the JAX
package on the CPU: mamba2-130m, zamba2-2.7b and seamless-m4t-large-v2
at the reduced configs on the meshes (2, 2), (1, 4) and (4, 1) of the
CPU listed four times.

The checks and their tolerances are ``tests/test_torch_lm_mesh_train.py``'s
(its module docstring), at 5e-4 of each leaf's largest JAX magnitude for
mamba2 and seamless, the unsharded tests' bound.  zamba2's is 1e-3, set
after a reading on the CPU: on this file's batch its ``conv_b``
gradient (a sum over every position with heavy cancellation) lies 3.7e-4
from JAX on the unsharded port and 6.1e-4 on the (1, 4) mesh, and JAX
against itself with every parameter scaled by ``1 + 1e-7·N(0, 1)`` moves
it by 1.0e-4 to 7.4e-4 over six draws: rounding, not a fault, at 1.22×
the unsharded bound.  ``launch.train.run(mesh="host4")`` runs mamba2
and zamba2; it feeds seamless no ``frames`` (ROADMAP.md, R10,
``tests/test_torch_lm_encdec_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jmamba
from repro_torch.models import mamba2
from test_torch_lm_mesh_train import (MESH_DIMS, check_meshes_agree_and_bitwise,
                                      check_mesh_grads, check_train_launcher,
                                      check_two_train_steps, reference)

# one xdist worker per core runs these files beside the JAX suite
torch.set_num_threads(2)

ARCHS = ["mamba2-130m", "zamba2-2.7b", "seamless-m4t-large-v2"]


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


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_train_launcher_runs_on_a_host4_cpu_mesh(arch, tmp_path):
    check_train_launcher(arch, tmp_path)


def _recurrence(x, dt, b_in, c_in, a):
    """The SSM as its recurrence, one position at a time (float64):
    ``h_t = exp(dt_t·a)·h_{t−1} + dt_t·x_t ⊗ b_t``, ``y_t = c_t · h_t``."""
    bsz, s, h, p = x.shape
    state = torch.zeros((bsz, h, p, b_in.shape[-1]), dtype=x.dtype)
    ys = []
    for t in range(s):
        state = torch.exp(dt[:, t] * a)[..., None, None] * state + \
            torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], b_in[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", c_in[:, t], state))
    return torch.stack(ys, 1)


def test_r11_ssd_gradient_is_finite_where_the_reference_is_nan():
    """ROADMAP.md, R11: the chunked SSD's decay matrix is the reference's
    ``where(tri, exp(li), 0)``, and where ``dt·a`` summed over a chunk
    passes float32's exp range (mamba2-130m at published width, 24
    layers, sequence 32, reads so) the masked entries above the diagonal
    overflow: the forward is finite, the JAX backward is NaN.  The port
    masks before the exp (the same values): its forward is JAX's within
    1e-5, and its gradients, finite, are the float64 recurrence's within
    1e-4 of each input's largest."""
    import types
    rng = np.random.default_rng(0)
    bsz, s, h, p, n = 1, 32, 2, 4, 8
    ins = [rng.normal(0, 1, (bsz, s, h, p)),            # x
           rng.uniform(1.5, 2, (bsz, s, h)),             # dt
           rng.normal(0, 1, (bsz, s, n)),                # b
           rng.normal(0, 1, (bsz, s, n)),                # c
           -rng.uniform(1.5, 2, (h,))]                   # a: dt·a ~ -3
    ins = [v.astype(np.float32) for v in ins]
    span = (ins[1] * ins[4]).sum(1).min()       # the chunk's cum range
    assert span < -89, "exp(li) must overflow float32 above the diagonal"
    ct = rng.normal(0, 1, (bsz, s, h, p)).astype(np.float32)
    cfg = types.SimpleNamespace(chunk=s)
    h0 = np.zeros((bsz, h, p, n), np.float32)

    def jloss(*args):
        y, _ = jmamba._ssd_chunk_scan(cfg, *args, jnp.asarray(h0))
        return (y * ct).sum(), y
    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                         has_aux=True)(
        *map(jnp.asarray, ins))
    assert np.isfinite(np.asarray(jy)).all()
    assert not all(np.isfinite(np.asarray(g)).all() for g in jgrads)

    def grads(dtype, fn):
        ts = [torch.tensor(v, dtype=dtype, requires_grad=True) for v in ins]
        y = fn(*ts)
        (y * torch.as_tensor(ct, dtype=dtype)).sum().backward()
        return y.detach(), [t.grad for t in ts]
    y, got = grads(torch.float32, lambda *t: mamba2._ssd_chunk_scan(
        cfg, *t, torch.as_tensor(h0))[0])
    want_y, want = grads(torch.float64, _recurrence)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), rtol=0,
                               atol=1e-4 * want_y.abs().max().item())
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * w.abs().max().item())
