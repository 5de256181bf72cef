"""LM serving launcher: batched greedy decode of an LM of any family
(port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama4-scout-17b-a16e --full --layers 8

Builds ``--arch`` (its reduced smoke config unless ``--full``) in
bfloat16 on ``--device`` (default cuda; raises where no GPU is visible),
with weights drawn from a ``torch.Generator`` seeded 0 on that device
(the JAX launcher draws ``jax.random.key(0)``, so the weights and tokens
differ from its run), and the JAX launcher's prompts:
``np.random.default_rng(0).integers(0, vocab, (batch, prompt_len))``.
It generates once to warm up, then times a second run (host clock,
ending in a device sync) and prints the JAX launcher's closing line,
``name: (B, max_new) in N ms (R tok/s)``.

``--layers N`` (not in the JAX launcher) cuts the depth to N layers at
unchanged widths, for the configs whose published size does not fit
the card (llama4-scout: a multiple of ``global_every``; deepseek-v2: its
dense first layer and N − 1 MoE layers; seamless: the decoder).  A
config that does not fit raises ``torch.OutOfMemoryError`` naming its
weight bytes.  ``encdec`` configs decode as the JAX ``generate`` does,
without ``frames`` (ROADMAP.md, R6).

``--mesh host<N>`` serves on a (data, model) mesh of N members with
``model = min(2, N)`` and ``tp`` its model extent, as the JAX launcher
(``launch.mesh.mesh_from_flag``: the first N GPUs where that many are
visible, else ``--device`` listed N times, whose members then run one
after another); ``single`` / ``multi`` build the production mesh and
need 256 / 512 visible GPUs.  A mesh serves every family: dense; moe
(llama4-scout and deepseek-v2: experts split over ``model``, routing
once over the global tokens); ssm and hybrid (mamba2-130m, zamba2-2.7b:
each mamba layer's ``in_proj`` columns over ``model``, the SSM state
split along its head dimension ``P``, zamba2's shared block per
superblock); encdec (seamless-m4t-large-v2: the encoder's and the
cross-attention's heads over ``model``; it decodes without ``frames``,
as the JAX ``generate`` does, R6).  Without ``--mesh`` the model is
unsharded on one device (the JAX launcher defaults to ``host8``).
``--cache-len N`` (not in the JAX launcher) sizes the decode cache
(default: prompt + new tokens, as ``generate``); at 1,024 or more a
cache whose heads cannot split over ``model`` (or deepseek's latent
cache, which has none) shards its length there, and at a batch that
cannot split over the data members its length goes over them.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --mesh host4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mesh host4 --arch deepseek-v2-236b --cache-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mesh host4 --arch zamba2-2.7b --batch 1 --cache-len 1024
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

__all__ = ["run", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _weight_bytes(cfg, dtype) -> int:
    """Bytes of ``cfg``'s weights as ``LM`` stores them (nothing
    allocated: counted on the meta device)."""
    from repro_torch.models.model import LM
    lm = LM(cfg, device="meta", dtype=dtype)
    return sum(p.numel() * p.element_size() for p in lm.parameters())


def run(arch: str = "qwen1.5-4b", *, batch: int = 8, prompt_len: int = 32,
        max_new: int = 16, full: bool = False, layers: int | None = None,
        device=None, mesh=None, cache_len: int | None = None) -> dict:
    """Build, warm up and time one ``generate`` → ``{"cfg", "lm",
    "prompts", "out", "seconds", "tok_per_s", "line", "mesh"}``.
    ``layers`` cuts the depth, ``mesh`` a ``--mesh`` string or a
    ``Mesh``, ``cache_len`` sizes the decode cache (see the module
    docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.launch.mesh import mesh_from_flag
    from repro_torch.models.model import LM
    from repro_torch.serve.decode import generate

    dev = resolve_device(device)
    mesh = mesh_from_flag(mesh, dev)
    tp = mesh.shape["model"] if mesh is not None else 1
    cfg = get_config(arch)
    if not full:
        cfg = reduced(cfg)
    if layers is not None:
        if cfg.global_every and layers % cfg.global_every:
            raise ValueError(f"{cfg.name}: --layers must be a multiple of "
                             f"its superblock of {cfg.global_every}")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    try:
        lm = LM(cfg, tp=tp, device=dev, mesh=mesh, dtype=torch.bfloat16)
        lm.init(torch.Generator(device=dev).manual_seed(0))
    except torch.OutOfMemoryError as e:
        raise torch.OutOfMemoryError(
            f"{cfg.name} at {cfg.n_layers} layers holds "
            f"{_weight_bytes(cfg, torch.bfloat16):,} bytes of bfloat16 "
            f"weights, more than {dev} can hold: cut its depth with "
            f"--layers") from e
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len), np.int32), device=dev)
    generate(lm, prompts, max_new=max_new, cache_len=cache_len)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    out = generate(lm, prompts, max_new=max_new, cache_len=cache_len)
    _sync(dev)
    dt = time.perf_counter() - t0
    line = (f"{cfg.name}: {tuple(out.shape)} in {dt * 1000:.0f} ms "
            f"({batch * max_new / dt:,.0f} tok/s)")
    return {"cfg": cfg, "lm": lm, "prompts": prompts, "out": out,
            "seconds": dt, "tok_per_s": batch * max_new / dt, "line": line,
            "mesh": mesh}


def main(argv: list[str] | None = None) -> dict:
    """CLI entry point (``argv`` overrides ``sys.argv``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the reduced "
                         "smoke config)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers at unchanged "
                         "widths (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--mesh", default=None,
                    help="host<N> | single | multi (default: no mesh)")
    ap.add_argument("--cache-len", type=int, default=None,
                    help="decode-cache positions (default: prompt + new)")
    args = ap.parse_args(argv)
    res = run(args.arch, batch=args.batch, prompt_len=args.prompt_len,
              max_new=args.max_new, full=args.full, layers=args.layers,
              device=args.device, mesh=args.mesh, cache_len=args.cache_len)
    print(res["line"], flush=True)
    return res


if __name__ == "__main__":
    main()
