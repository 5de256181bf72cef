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
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models.attention import _project_qkv, attn_decode
from repro.models.common import expand_kv, rms_norm
from repro.models.model import LM
from repro.models.moe import mlp_apply

BATCH, LEN = 8, 16


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--layers", type=int, default=10)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if cfg.family != "dense":
        raise SystemExit(f"{args.arch}: dense configs only")
    cfg = dataclasses.replace(cfg, n_layers=args.layers)
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


if __name__ == "__main__":
    main()
