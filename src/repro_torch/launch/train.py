"""LM training launcher: seeded init, the synthetic token stream, the
microbatched AdamW step and supervised checkpoints (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 20

Builds ``--arch`` (its reduced smoke config unless ``--full``) as an
``LM(trainable=True)`` — float32 master weights, bfloat16 compute,
remat — on ``--device`` (default cuda; raises where no GPU is visible),
weights drawn from a ``torch.Generator`` seeded 0 on that device (the
JAX launcher draws ``jax.random.key(0)``, so the weights differ from
its run).  The data is the JAX launcher's: ``lm_token_stream(200_000,
vocab, seed=0)`` through a ``ShardedLoader`` of ``--global-batch`` rows
of ``--seq`` tokens.  Training runs under ``run_with_recovery``: a
checkpoint of the initial ``TrainState`` at step 0 (the JAX launcher
writes none; the port's step updates in place, so a failure is always
replayed from a checkpoint) and an asynchronous one every
``--ckpt-every`` steps into ``--ckpt-dir`` (the JAX ``TrainState``
tree, layers stacked, so either package restores the other's), restart
from the latest one on a failure, and a run started on a directory that holds checkpoints
resumes from the newest.  Step ``i`` always trains on the loader's
batch ``i`` (the loader is re-opened at the step a restart resumes
from; the JAX launcher's loader runs on from where it stood), so a
resumed run sees the batches an unbroken run sees.

``--mesh host<N>`` / ``single`` / ``multi`` trains on a mesh as
``launch.serve`` builds it (``tp`` its model extent), for every
family.  As the JAX launcher, it feeds no ``frames`` and no ``prefix``
(ROADMAP.md, R10), so seamless and internvl2 fail on a ``KeyError``
with a mesh or without.  The checkpoints
hold the gathered JAX layout, file for file as without a mesh, and a
restart re-slices them for the run's mesh.  Without ``--mesh`` the model
is unsharded (the JAX launcher defaults to ``host8``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 4 --mesh host4
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

__all__ = ["run", "main"]

STREAM_TOKENS = 200_000


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(arch: str = "tinyllama-1.1b", *, steps: int = 100,
        global_batch: int = 8, seq: int = 128, n_micro: int = 1,
        full: bool = False, ckpt_dir: str | None = None,
        ckpt_every: int = 50, device=None, mesh=None) -> dict:
    """Train ``steps`` steps → ``{"cfg", "lm", "state", "losses",
    "step_s", "tokens_per_step", "mesh"}``: the loss of every step run (a
    restart's replayed steps included) and its host time, each step
    ending in a device sync.  ``mesh``: a ``--mesh`` string or a
    ``Mesh``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.data import ShardedLoader, lm_token_stream
    from repro_torch.distributed.fault_tolerance import run_with_recovery
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.launch.mesh import mesh_from_flag
    from repro_torch.models.model import LM
    from repro_torch.train.step import (TrainHParams, init_train_state,
                                        make_train_step)

    dev = resolve_device(device)
    mesh = mesh_from_flag(mesh, dev)
    tp = mesh.shape["model"] if mesh is not None else 1
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "repro_torch_launch_ckpt")
    cfg = get_config(arch)
    if not full:
        cfg = reduced(cfg)
    lm = LM(cfg, tp=tp, device=dev, mesh=mesh, dtype=torch.bfloat16,
            trainable=True)
    lm.init(torch.Generator(device=dev).manual_seed(0))
    hp = TrainHParams(total_steps=steps, n_micro=n_micro)
    step_fn = make_train_step(lm, hp)
    state = init_train_state(lm.params)
    stream = lm_token_stream(STREAM_TOKENS, cfg.vocab_size, seed=0)
    loaders = [None]
    losses, step_s = [], []

    def batch_for(i: int):
        loader = loaders[0]
        if loader is None or loader.step != i:
            if loader is not None:
                loader.close()
            loader = loaders[0] = ShardedLoader(
                stream, global_batch=global_batch, seq_len=seq, start_step=i)
        tokens, targets = next(loader)
        return {"tokens": tokens, "targets": targets}

    def one_step(state, i):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch_for(i))
        loss = float(metrics["loss"])           # syncs the device
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if (i + 1) % 10 == 0:
            print(f"step {i + 1} loss {loss:.3f}", flush=True)
        return state

    try:
        state = run_with_recovery(one_step, state, n_steps=steps,
                                  ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)
    finally:
        if loaders[0] is not None:
            loaders[0].close()
    print(f"training complete; final step {int(state.step)}", flush=True)
    return {"cfg": cfg, "lm": lm, "state": state, "losses": losses,
            "step_s": step_s, "tokens_per_step": global_batch * seq,
            "mesh": mesh}


def main(argv: list[str] | None = None) -> dict:
    """CLI entry point (``argv`` overrides ``sys.argv``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--mesh", default=None,
                    help="host<N> | single | multi (default: no mesh)")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the reduced "
                         "smoke config)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: "
                         "repro_torch_launch_ckpt under the temp dir)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    return run(args.arch, steps=args.steps, global_batch=args.global_batch,
               seq=args.seq, n_micro=args.n_micro, full=args.full,
               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
               device=args.device, mesh=args.mesh)


if __name__ == "__main__":
    main()
