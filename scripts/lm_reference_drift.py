#!/usr/bin/env python
"""Prefill against decode on the JAX reference LM at a published width.

Builds the JAX ``LM`` for a dense config at its full width, truncated to
``--layers`` layers, in float32 with the weights of ``LM.init(key(0))``
and the serving launcher's prompts (``np.random.default_rng(0)``, 8 rows,
the first 16 of its 32 tokens, as ``chip_smoke.py`` phase 13 takes).  Runs the prompt through prefill,
and through ``decode_step`` one token at a time, then the last token
layer by layer through the decode body over the cache that stepping
filled.  Prints layer 0's attention scores (std, largest magnitude) and,
after each layer, the last position's hidden-state drift
``max |decode - prefill| / max |prefill|``; after the last layer, the
greedy picks of both paths and their largest logit difference.  These
are the same quantities that ``chip_smoke.py`` phase 13 prints for the
PyTorch port, read here on the reference itself (ROADMAP.md, R5).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/lm_reference_drift.py \\
        --arch qwen1.5-4b --layers 10

Its weights take ``4 * (2 * vocab * d_model + layers * per-layer
params)`` bytes; the process peaked at 11.0 GB of host memory for
qwen1.5-4b at 10 layers, 17.9 GB at 20, and 9.0 GB for tinyllama-1.1b at
its full 22.

With ``--grads``, it reads instead the global gradient norm of
``LM.loss`` at published width on the first ``--depths`` layers of the
same full-depth weights, once per ``--dtype`` (the compute dtype; the
parameters stay float32, as in training), on the JAX reference and on
the PyTorch port on the CPU, the port holding the reference's weights
(``convert.lm_params_from_numpy``).  The batch is the one the training
launchers start from: the first ``(8, 128)`` batch of
``lm_token_stream(200_000, vocab, seed=0)``.  One JSON line per depth
and package gives the loss, the norm and its parts (embedding, each
layer, final norm, head):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/lm_reference_drift.py \
        --grads --arch tinyllama-1.1b --depths 2,5,10,22 --dtype float32

tinyllama-1.1b's weights and gradients at 22 layers take 8.8 GB on each
side; the port's side runs after the reference's gradients are freed.

With ``--card``, it reads on a CUDA device, through the port alone (no
JAX is imported), the two port readings that ``chip_smoke.py`` gates at
a cut depth or dtype: tinyllama-1.1b's fit of one fixed batch at its
full published depth (phase 14's gate 2 set-up and weights) and
zamba2-2.7b's free-running prefill-vs-decode picks at its first
superblock in bfloat16 (phase 13's check 1a set-up and weights).  One
JSON line each:

    PYTHONPATH=src python scripts/lm_reference_drift.py --card
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

BATCH, LEN = 8, 16
TRAIN_BATCH, TRAIN_SEQ, STREAM_TOKENS = 8, 128, 200_000
ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--layers", type=int, default=10)
    ap.add_argument("--grads", action="store_true",
                    help="read gradient norms by depth instead")
    ap.add_argument("--depths", default="2,5,10,22")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--card", action="store_true",
                    help="read the port's card readings instead")
    args = ap.parse_args()
    if args.card:
        card_readings()
        return

    from repro.configs import get_config
    cfg = get_config(args.arch)
    if cfg.family != "dense":
        raise SystemExit(f"{args.arch}: dense configs only")
    if args.grads:
        grad_norms(cfg, [int(d) for d in args.depths.split(",")],
                   args.dtype)
    else:
        drift(dataclasses.replace(cfg, n_layers=args.layers))


def drift(cfg) -> None:
    """The default reading: prefill against decode on the reference."""
    import jax
    import jax.numpy as jnp

    from repro.models.attention import _project_qkv, attn_decode
    from repro.models.common import expand_kv, rms_norm
    from repro.models.model import LM
    from repro.models.moe import mlp_apply

    lm = LM(cfg, tp=1, remat=False, compute_dtype=jnp.float32)
    params = lm.init(jax.random.key(0))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, 32), np.int32)
    toks = jnp.asarray(prompts[:, :LEN])
    s, eps, a = LEN, cfg.norm_eps, lm.attn_cfg
    layer = [jax.tree.map(lambda t, i=i: t[i], params["layers"])
             for i in range(cfg.n_layers)]

    # layer 0's attention scores on the prefill path, before the mask
    x = rms_norm(lm._embed(params, toks), layer[0]["ln1"], eps)
    q, k, _ = _project_qkv(a, layer[0]["attn"], x, jnp.arange(s))
    sc = jnp.einsum("bqhd,bkhd->bhqk", q, expand_kv(k, a.rep)) / \
        np.sqrt(a.head_dim)

    body = jax.jit(lm._dense_body(False))
    x, ref = lm._embed(params, toks), []
    for lp in layer:
        x, _ = body(x, lp)
        ref.append(x[:, -1])
    logits = lm._logits(params, rms_norm(x[:, -1:], params["final_norm"],
                                         eps))[:, 0]

    step = jax.jit(lm.decode_step)
    cache = lm.init_cache(BATCH, s)
    for pos in range(s - 1):
        _, cache = step(params, cache, toks[:, pos:pos + 1], jnp.int32(pos))

    @jax.jit
    def decode_layer(x, lp, ck, cv):
        y, _, _ = attn_decode(a, lp["attn"], rms_norm(x, lp["ln1"], eps),
                              ck, cv, jnp.int32(s - 1))
        x = x + y
        return x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"], eps))

    xd, drift = lm._embed(params, toks[:, -1:]), {}
    for i, lp in enumerate(layer):
        xd = decode_layer(xd, lp, cache["k"][i], cache["v"][i])
        drift[i + 1] = float(jnp.abs(xd[:, 0] - ref[i]).max()
                             / jnp.abs(ref[i]).max())
    dlogits = lm._logits(params, rms_norm(xd, params["final_norm"],
                                          eps))[:, 0]
    v = cfg.vocab_size
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers, "batch": BATCH,
        "len": s, "dtype": "float32", "platform": jax.devices()[0].platform,
        "layer0_scores": {"std": float(sc.std()),
                          "max_abs": float(jnp.abs(sc).max())},
        "drift": drift,
        "picks_equal": int((jnp.argmax(logits[:, :v], -1)
                            == jnp.argmax(dlogits[:, :v], -1)).sum()),
        "max_abs_logit_diff": float(jnp.abs(logits[:, :v]
                                            - dlogits[:, :v]).max())}))


def _parts(sq, leaves, grads, n_layers: int) -> dict:
    """The gradient norm's parts: each top-level entry's, and layer i's
    over the stacked ``layers`` leaves (``sq(x)`` → float32 Σ x²,
    ``leaves`` the package's tree flattening)."""
    out = {k: float(np.sqrt(sum(sq(x) for x in leaves(v))))
           for k, v in grads.items() if k != "layers"}
    out["layers"] = [float(np.sqrt(sum(sq(x[i]) for x in
                                       leaves(grads["layers"]))))
                     for i in range(n_layers)]
    return out


def grad_norms(cfg, depths: list, dtype: str) -> None:
    """``--grads``: the reference's, then the port's, global gradient
    norm of one batch's loss at each depth (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.data import ShardedLoader, lm_token_stream
    from repro.models.model import LM
    from repro.optim.adamw import global_norm
    from repro_torch import tree as ttree
    from repro_torch.configs import get_config as port_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models.model import LM as PortLM
    from repro_torch.optim import global_norm as port_global_norm

    stream = lm_token_stream(STREAM_TOKENS, cfg.vocab_size, seed=0)
    loader = ShardedLoader(stream, global_batch=TRAIN_BATCH,
                           seq_len=TRAIN_SEQ)
    tokens, targets = next(loader)
    loader.close()
    batch = {"tokens": np.asarray(tokens), "targets": np.asarray(targets)}
    params = LM(cfg, tp=1).init(jax.random.key(0))
    head = {"arch": cfg.name, "dtype": dtype, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "init": "LM.init(jax.random.key(0)) at "
            f"{cfg.n_layers} layers, truncated"}

    def truncated(tree, d):
        return {**tree, "layers": jax.tree.map(lambda t: t[:d],
                                               tree["layers"])}

    for d in depths:
        jlm = LM(dataclasses.replace(cfg, n_layers=d), tp=1,
                 compute_dtype=getattr(jnp, dtype))
        sub = params if d == cfg.n_layers else truncated(params, d)
        (loss, _), g = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
            sub, jax.tree.map(jnp.asarray, batch))
        sq = lambda x: float(jnp.sum(jnp.square(x.astype(jnp.float32))))  # noqa: E731
        print(json.dumps({**head, "package": "jax", "layers": d,
                          "loss": float(loss),
                          "grad_norm": float(global_norm(g)),
                          "parts": _parts(sq, jax.tree.leaves, g, d)}),
              flush=True)
        del g, sub
    host = jax.tree.map(np.asarray, params)
    for d in depths:
        lm = PortLM(dataclasses.replace(port_config(cfg.name), n_layers=d),
                    device="cpu", dtype=getattr(torch, dtype),
                    trainable=True)
        lm_params_from_numpy(truncated(host, d), lm)
        loss, _ = lm.loss({k: torch.as_tensor(v) for k, v in batch.items()})
        loss.backward()
        sq = lambda x: float(torch.sum(torch.square(x.float())))  # noqa: E731
        print(json.dumps({**head, "package": "repro_torch", "layers": d,
                          "loss": float(loss.detach()),
                          "grad_norm": float(port_global_norm(lm.grads)),
                          "parts": _parts(sq, ttree.leaves, lm.grads, d)}),
              flush=True)
        del lm


def card_readings() -> None:
    """``--card``: the port's full-depth fit and zamba2's bfloat16 check
    1a, with ``chip_smoke.py``'s set-up, weights and helpers."""
    import torch
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, lm_token_stream
    from repro_torch.launch.serve import run
    from repro_torch.models.model import LM

    card = smoke.smi("name,power.limit")
    cfg = get_config(smoke.LM_TRAIN_ARCH)
    lm = LM(cfg, device="cuda", dtype=torch.bfloat16, trainable=True)
    lm.init(torch.Generator(device="cuda").manual_seed(0))
    loader = ShardedLoader(lm_token_stream(STREAM_TOKENS, cfg.vocab_size,
                                           seed=0),
                           global_batch=smoke.LM_TRAIN_BATCH,
                           seq_len=smoke.LM_TRAIN_SEQ)
    tokens, targets = next(loader)
    loader.close()
    fit = smoke.fit_fixed_batch(torch, lm, {"tokens": tokens,
                                            "targets": targets})
    print(json.dumps({"reading": "fit", "arch": cfg.name,
                      "layers": cfg.n_layers, "card": card,
                      "steps": smoke.LM_TRAIN_FIT_STEPS,
                      "peak_lr": smoke.LM_TRAIN_FIT_LR, **fit}), flush=True)
    del lm, fit
    torch.cuda.empty_cache()

    res = run("zamba2-2.7b", batch=smoke.LM_BATCH,
              prompt_len=smoke.LM_PROMPT, max_new=1, full=True,
              device="cuda")
    depth = smoke.lm_depth(res["cfg"], smoke.LM_FREE_DEPTH)
    fr = smoke.lm_free_running(
        torch, res["lm"], smoke.lm_first_units(res["lm"], depth),
        res["prompts"][:, :smoke.LM_CONSIST_LEN], torch.bfloat16)
    print(json.dumps({"reading": "free_running", "arch": res["cfg"].name,
                      "layers": depth, "dtype": "bfloat16", "card": card,
                      **{k: fr[k] for k in ("exact", "rows", "max_gap",
                                            "within", "gaps", "tols",
                                            "drift")}}), flush=True)


if __name__ == "__main__":
    main()
