"""Roofline analysis (port of ``repro.roofline.analysis``).

Three terms per (arch × shape × mesh), all in seconds per step per
device:

    compute    = FLOPs / peak FLOP/s
    memory     = bytes / HBM bytes/s
    collective = collective bytes / link bytes/s

:class:`HW` keeps the JAX package's TPU v5e numbers as its default, so
:func:`roofline_terms` agrees with the JAX function; :data:`H100` is the
card the port runs on.  :func:`n_params_active` and :func:`model_flops`
are the JAX functions, analytic from the config.

Left out (an API difference): ``collective_bytes``, which parses the
collectives out of XLA's HLO text; torch produces no HLO, and
``launch/dryrun.py`` counts what the port's own mesh moves instead.

The decode-step bytes bound (:func:`lm_decode_bytes` and its helpers)
counts what one decode step of an unsharded ``LM`` must read and write;
``chip_smoke.py`` divides it by the card's HBM rate.
"""

from __future__ import annotations

import dataclasses

__all__ = ["HW", "H100", "roofline_terms", "n_params_active", "model_flops",
           "lm_state_bytes", "lm_cache_moves", "lm_expert_bytes",
           "lm_decode_bytes"]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 197e12      # bf16 per chip (TPU v5e-ish)
    hbm_bw: float = 819e9           # bytes/s per chip
    ici_bw: float = 50e9            # bytes/s per link


# NVIDIA H100 SXM datasheet (700 W): 989 TFLOP/s dense bf16 on the tensor
# cores, 3.35 TB/s of HBM3, NVLink 900 GB/s per GPU counted both ways
# (450 GB/s each way)
H100 = HW(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9)


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, hw: HW = HW()) -> dict:
    t_c = flops_per_dev / hw.peak_flops
    t_m = bytes_per_dev / hw.hbm_bw
    t_n = coll_bytes_per_dev / hw.ici_bw
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_n}
    dom = max(terms, key=terms.get)
    bound = max(t_c, t_m, t_n)
    return {**terms, "bottleneck": dom.replace("_s", ""),
            "roofline_fraction": (t_c / bound) if bound else 0.0,
            "step_lower_bound_s": bound}


def n_params_active(cfg) -> tuple[float, float]:
    """(total params, active-per-token params) — analytic, from config."""
    c = cfg
    e = c.d_model
    emb = c.padded_vocab * e * (1 if c.tie_embeddings else 2)

    def attn_params():
        if c.use_mla:
            qk = c.nope_head_dim + c.rope_head_dim
            return (e * c.q_lora + c.q_lora * c.n_heads * qk
                    + e * c.kv_lora + e * c.rope_head_dim
                    + c.kv_lora * c.n_heads * (c.nope_head_dim
                                               + c.v_head_dim)
                    + c.n_heads * c.v_head_dim * e)
        hd = c.head_dim
        return e * hd * (c.n_heads * 2 + c.n_kv_heads * 2)

    def mlp_params(ff):
        return 3 * e * ff

    if c.family == "dense":
        layer = attn_params() + mlp_params(c.d_ff)
        total = emb + c.n_layers * layer
        return total, total
    if c.family == "moe":
        expert = mlp_params(c.moe_d_ff)
        shared = mlp_params(c.shared_d_ff) if c.n_shared_experts else 0
        router = e * c.n_experts
        n_moe = c.n_layers - c.first_dense
        moe_all = n_moe * (attn_params() + router + shared
                           + c.n_experts * expert)
        moe_act = n_moe * (attn_params() + router + shared
                           + c.top_k * expert)
        dense = c.first_dense * (attn_params() + mlp_params(c.d_ff))
        return emb + dense + moe_all, emb + dense + moe_act
    if c.family == "ssm":
        di = c.ssm_expand * e
        nh = di // c.ssm_head_dim
        layer = (e * (2 * di + 2 * c.ssm_state + nh)
                 + (di + 2 * c.ssm_state) * c.conv_kernel + di * e)
        total = emb + c.n_layers * layer
        return total, total
    if c.family == "hybrid":
        di = c.ssm_expand * e
        nh = di // c.ssm_head_dim
        mlayer = (e * (2 * di + 2 * c.ssm_state + nh)
                  + (di + 2 * c.ssm_state) * c.conv_kernel + di * e)
        shared = attn_params() + mlp_params(c.d_ff)
        total = emb + c.n_layers * mlayer + shared
        # shared block applied n_layers/every times — active FLOPs count all
        act = emb + c.n_layers * mlayer \
            + (c.n_layers // c.shared_attn_every) * shared
        return total, act
    if c.family == "encdec":
        enc = c.n_enc_layers * (attn_params() + mlp_params(c.d_ff))
        dec = c.n_layers * (2 * attn_params() + mlp_params(c.d_ff))
        total = emb + enc + dec
        return total, total
    raise ValueError(c.family)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS per the brief: 6·N·D (train) / 2·N·D (fwd-only), with
    N = active params (MoE) and D = tokens processed in the step.
    Attention score FLOPs deliberately excluded (standard 6ND convention)."""
    _, act = n_params_active(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * act * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * act * tokens
    # decode: one token per sequence
    return 2.0 * act * shape.global_batch


def lm_state_bytes(lm, batch: int) -> int:
    """Bytes of the mamba layers' decode state at ``batch`` rows: the
    conv window in the compute dtype and the float32 SSM state (0 for
    the families without mamba layers)."""
    c = lm.cfg
    if c.family not in ("ssm", "hybrid"):
        return 0
    m = lm.mamba_cfg
    conv = m.conv_dim * (m.conv_kernel - 1) * lm.embed.element_size()
    return c.n_layers * batch * (conv + m.n_heads * m.head_dim * m.d_state
                                 * 4)


def lm_cache_moves(lm, pos: int, cache_len: int) -> list:
    """What a decode step at ``pos`` (in a cache of ``cache_len``
    positions) must read and write of the attention caches, per row: ``(sites, entries read, entries written, bytes an
    entry)`` — the valid slots of every self-attention site (a window
    or chunk keeps fewer), MLA's latent (``c_kv`` and ``k_pe``), and the
    ``encdec`` decoder's cross-attention ``xk`` / ``xv`` (read, never
    written)."""
    c, elt = lm.cfg, lm.embed.element_size()
    if c.family == "ssm":
        return []
    if c.use_mla:
        m = lm.mla_cfg
        return [(c.n_layers, pos + 1, 1, (m.kv_lora + m.rope_head_dim) * elt)]
    a = lm.attn_cfg
    kv = a.hkv * a.head_dim * 2 * elt
    if c.family == "hybrid":
        return [(c.n_layers // c.shared_attn_every, pos + 1, 1, kv)]
    if c.family == "moe":                      # llama4: chunked + global
        nsb = c.n_layers // c.global_every
        return [(nsb * (c.global_every - 1), pos % c.chunk + 1, 1, kv),
                (nsb, pos + 1, 1, kv)]
    slots = min(pos + 1, c.window) if c.window else pos + 1
    out = [(c.n_layers, slots, 1, kv)]
    if c.family == "encdec":
        out.append((c.n_layers, max(1, cache_len // c.enc_len_ratio), 0, kv))
    return out


def lm_expert_bytes(lm) -> tuple[int, int]:
    """(MoE layers, bytes of one routed expert's three matrices)."""
    if not lm.cfg.n_experts:
        return 0, 0
    c = lm.moe_cfg
    elt = lm.embed.element_size()
    n_moe = sum(1 for name, _ in lm.named_parameters()
                if name.endswith(".moe.router"))
    return n_moe, 3 * c.d_model * c.d_ff * elt


def lm_decode_bytes(lm, batch: int, pos: int, cache_len: int,
                    experts_hit: list | None = None) -> int:
    """Bytes one decode step at ``pos`` (in a cache of ``cache_len``
    positions) must move: every stored matrix,
    bias and float32 vector the step uses read once (of the embedding
    only the batch's rows, unless it is the tied head; not the
    encoder's, nor the cross-attention's key and value projections),
    the attention caches'
    ``lm_cache_moves``, and the mamba layers' state read and written
    once.  The routed experts count whole (the reference's formulation
    computes every expert), or, with ``experts_hit`` (per MoE layer, the
    distinct experts the step's kept tokens route to), only those."""
    c = lm.cfg
    nbytes = 0
    for name, p in lm.named_parameters():
        if name.startswith(("encoder.", "enc_norm")) or \
                name.endswith((".xattn.wk", ".xattn.wv")):
            continue              # the encoder's side: no decode step reads it
        if name == "embed" and not c.tie_embeddings:
            nbytes += batch * p.shape[1] * p.element_size()
        else:
            nbytes += p.numel() * p.element_size()
    if experts_hit is not None:
        n_moe, per = lm_expert_bytes(lm)
        nbytes -= (n_moe * c.n_experts - sum(experts_hit)) * per
    for sites, read, written, entry in lm_cache_moves(lm, pos, cache_len):
        nbytes += sites * batch * entry * (read + written)
    return nbytes + 2 * lm_state_bytes(lm, batch)
