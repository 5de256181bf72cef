"""BNN with xnor-popcount neurons and time-domain activations (paper §V;
the port's counterpart of ``examples/bnn_popcount.py``).

Trains a binarized 784-128-10 MLP (straight-through estimator) for 150
steps on the MNIST stand-in ``mnist_like(60)``, then runs inference three
ways and compares:

1. the ±1 GEMM through kernel K6 (``binary_matmul.binary_matmul``) on int8
   operands, checked against an int32 matmul on the CPU;
2. hidden sign activations from PDL races against a neutral half-ones
   line (the paper's proposed hidden layer);
3. the output argmax through the arbiter tournament.

    PYTHONPATH=src python -m repro_torch.launch.bnn_popcount
    PYTHONPATH=src python -m repro_torch.launch.bnn_popcount --device cpu

``--device`` defaults to cuda and raises where no GPU is visible.  The
master weights start from ``torch.Generator`` seed 0 and the PDL device
and jitter from the port's threefry keys 5 and 6 (``jax.random.key(5)``
and ``key(6)`` in the example), so the trained weights, and with them
the accuracies, differ from the JAX example's; the time-domain path on
identical weights is held to JAX by ``tests/test_torch_bnn.py``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

STEPS, LR = 150, 0.03


def run(device=None) -> dict:
    """Train and run the three inference paths on ``device`` (``None`` →
    cuda) → ``{"losses", "test_acc", "h_shape", "agreement", "td_acc"}``;
    raises if the K6 product differs from the int32 matmul."""
    from repro_torch.core import prng
    from repro_torch.core.bnn import (BNNConfig, binarize_ste, bnn_apply,
                                      bnn_loss, bnn_predict_time_domain,
                                      init_bnn)
    from repro_torch.core.booleanize import threshold_booleanize
    from repro_torch.core.time_domain import PDLConfig, make_device
    from repro_torch.data import mnist_like
    from repro_torch.kernels import ops
    from repro_torch.kernels.binary_matmul import binary_matmul

    dev = ops.resolve_device(device)
    x, y = mnist_like(n_per_class=60, seed=0)
    xb = threshold_booleanize(x, 75.0).astype(np.float32)
    x_pm1 = torch.as_tensor(2 * xb - 1, device=dev)
    y = torch.as_tensor(y, device=dev)
    n_tr = int(0.8 * len(y))

    cfg = BNNConfig(in_features=784, hidden=(128,), n_classes=10)
    params = init_bnn(cfg, torch.Generator().manual_seed(0), device=dev)
    ws = [w.requires_grad_() for w in params.weights]
    losses, accs = [], []
    for i in range(STEPS):
        loss = bnn_loss(cfg, type(params)(tuple(ws)), x_pm1[:n_tr], y[:n_tr])
        grads = torch.autograd.grad(loss, ws)
        with torch.no_grad():
            ws = [(w - LR * g).requires_grad_() for w, g in zip(ws, grads)]
        if (i + 1) % 50 == 0:
            with torch.no_grad():
                pred = bnn_apply(cfg, type(params)(tuple(ws)),
                                 x_pm1[n_tr:]).argmax(-1)
            acc = float((pred == y[n_tr:]).float().mean())
            losses.append(float(loss.detach()))
            accs.append(acc)
            print(f"step {i + 1:4d} loss {losses[-1]:.4f} test acc "
                  f"{acc:.3f}", flush=True)
    params = type(params)(tuple(w.detach() for w in ws))

    # inference path 1: the ±1 GEMM kernel (K6) on int8 operands
    w0 = binarize_ste(params.weights[0]).to(torch.int8).contiguous()
    xi = x_pm1[n_tr:].to(torch.int8).contiguous()
    h = binary_matmul(xi, w0)
    h_ref = xi.cpu().to(torch.int32) @ w0.cpu().to(torch.int32)
    if h.dtype != torch.int32 or not torch.equal(h.cpu(), h_ref):
        raise AssertionError("xnor-popcount GEMM differs from the int32 "
                             "matmul")
    print(f"xnor-popcount GEMM kernel matches the int32 matmul: OK "
          f"{tuple(h.shape)} on {h.device}", flush=True)

    # inference paths 2 + 3: time-domain sign + arbiter argmax
    pdl = PDLConfig(sigma_elem=2.0, sigma_noise=0.5)
    devices = [make_device(pdl, cfg.hidden[0] + 1, cfg.in_features,
                           prng.key(5, device=dev))]
    with torch.no_grad():
        pred_td = bnn_predict_time_domain(cfg, params, pdl, devices,
                                          x_pm1[n_tr:],
                                          key=prng.key(6, device=dev))
        pred_ref = bnn_apply(cfg, params, x_pm1[n_tr:]).argmax(-1)
    agree = float((pred_td == pred_ref).float().mean())
    acc_td = float((pred_td == y[n_tr:]).float().mean())
    print(f"time-domain BNN inference: agreement with exact {agree:.3f}, "
          f"accuracy {acc_td:.3f}", flush=True)
    return {"losses": losses, "test_acc": accs, "h_shape": tuple(h.shape),
            "agreement": agree, "td_acc": acc_td}


def main(argv: list[str] | None = None) -> dict:
    """CLI entry point (``argv`` overrides ``sys.argv``)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
