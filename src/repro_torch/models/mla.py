"""Multi-head Latent Attention (DeepSeek-V2; port of ``repro.models.mla``).

KV compressed to a per-token latent ``c_kv`` of rank ``kv_lora`` (plus a
decoupled RoPE key ``k_pe`` shared across heads); queries via a rank
``q_lora`` bottleneck.  The decode cache stores only ``(c_kv, k_pe)``.

Prefill (:func:`mla_apply`) decompresses per-head keys and values and
runs the shared attention helpers.  Decode (:func:`mla_decode`) has the
reference's two forms: ``absorbed=True`` (the default, which ``LM``
uses) folds ``w_uk`` into the query and ``w_uv`` into the output so the
scores run against the latent cache; ``absorbed=False`` decompresses the
cache.  Both follow the JAX dtypes step by step: their score products
are in the compute dtype and only then float32 (unlike
``common.attention``'s float32 products), so a bfloat16 decode rounds
where the reference rounds.

``MLACfg.hq`` pads query heads to a multiple of ``tp``; ``_mask_heads``
zeroes the padded heads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .common import (ParamDef, apply_rope, attention, blockwise_attention,
                     rms_norm, rotary)

__all__ = ["MLACfg", "mla_defs", "mla_apply", "mla_decode"]

BLOCKWISE_THRESHOLD = 8192   # prefill switches to online-softmax blocks


class MLACfg(NamedTuple):
    d_model: int
    n_heads: int
    kv_lora: int = 512
    q_lora: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    rope_theta: float = 1e4
    tp: int = 16

    @property
    def hq(self) -> int:
        return -(-self.n_heads // self.tp) * self.tp

    @property
    def qk_dim(self) -> int:
        return self.nope_head_dim + self.rope_head_dim


def mla_defs(c: MLACfg) -> dict:
    e, h = c.d_model, c.hq
    return {
        "w_dq": ParamDef((e, c.q_lora), ("embed", None)),
        "q_norm": ParamDef((c.q_lora,), (None,), init="ones"),
        "w_uq": ParamDef((c.q_lora, h, c.qk_dim), (None, "heads", None)),
        "w_dkv": ParamDef((e, c.kv_lora), ("embed", None)),
        "kv_norm": ParamDef((c.kv_lora,), (None,), init="ones"),
        "w_kpe": ParamDef((e, c.rope_head_dim), ("embed", None)),
        "w_uk": ParamDef((c.kv_lora, h, c.nope_head_dim),
                         (None, "heads", None)),
        "w_uv": ParamDef((c.kv_lora, h, c.v_head_dim), (None, "heads", None)),
        "wo": ParamDef((h, c.v_head_dim, e), ("heads", None, "embed")),
    }


def _mask_heads(c: MLACfg, out: torch.Tensor,
                heads: slice | None = None) -> torch.Tensor:
    """Zero the padded heads of ``out`` (B, S, hq, D), or of the query
    heads ``heads`` it holds."""
    if c.hq == c.n_heads:
        return out
    m = torch.arange(c.hq, device=out.device) < c.n_heads
    if heads is not None:
        m = m[heads]
    return out * m.reshape(1, 1, -1, 1).to(out.dtype)


def _up(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsl,lhd->bshd")`` as one matrix product in ``x``'s
    dtype."""
    b, s, l_ = x.shape
    _, h, d = w.shape
    return (x @ w.to(x.dtype).reshape(l_, h * d)).view(b, s, h, d)


def _queries(c: MLACfg, p, x: torch.Tensor, positions: torch.Tensor):
    cq = rms_norm(x @ p["w_dq"].to(x.dtype), p["q_norm"])
    q = _up(cq, p["w_uq"])
    q_nope, q_pe = q.split([c.nope_head_dim, c.rope_head_dim], dim=-1)
    cos, sin = rotary(positions, c.rope_head_dim, c.rope_theta)
    q_pe = apply_rope(q_pe, cos, sin)
    return torch.cat([q_nope, q_pe], -1)                 # (B,S,H,qk_dim)


def _latents(c: MLACfg, p, x: torch.Tensor, positions: torch.Tensor):
    ckv = rms_norm(x @ p["w_dkv"].to(x.dtype), p["kv_norm"])   # (B,S,L)
    kpe = (x @ p["w_kpe"].to(x.dtype))[:, :, None, :]          # (B,S,1,Dr)
    cos, sin = rotary(positions, c.rope_head_dim, c.rope_theta)
    kpe = apply_rope(kpe, cos, sin)[:, :, 0]                   # (B,S,Dr)
    return ckv, kpe


def _decompress(c: MLACfg, p, ckv: torch.Tensor, kpe: torch.Tensor,
                dtype) -> tuple[torch.Tensor, torch.Tensor]:
    ckv = ckv.to(dtype)
    k_nope = _up(ckv, p["w_uk"])
    k = torch.cat([k_nope, kpe.to(dtype)[:, :, None, :].expand(
        *k_nope.shape[:3], c.rope_head_dim)], -1)
    v = _up(ckv, p["w_uv"])
    return k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshd,hde->bse")`` as one matrix product."""
    b, s, h, d = out.shape
    return out.reshape(b, s, h * d) @ wo.to(out.dtype).reshape(h * d, -1)


def mla_apply(c: MLACfg, p, x: torch.Tensor, *, q_offset: int = 0,
              heads: slice | None = None) -> tuple[torch.Tensor, tuple]:
    """Prefill.  x: (B, S, E) → (y, (c_kv, k_pe)), the latent cache.  On
    a mesh, ``p`` holds one member's query heads (``heads`` of the
    padded ``hq``: ``w_uq`` / ``w_uk`` / ``w_uv`` / ``wo``) and ``y`` is
    its partial output projection."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device) + q_offset
    q = _queries(c, p, x, positions)
    ckv, kpe = _latents(c, p, x, positions)
    k, v = _decompress(c, p, ckv, kpe, x.dtype)
    fn = blockwise_attention if s > BLOCKWISE_THRESHOLD else attention
    out = fn(q, k, v, kind="causal", q_offset=q_offset)
    out = _mask_heads(c, out, heads)
    return _out_proj(out, p["wo"]), (ckv, kpe)


def mla_decode(c: MLACfg, p, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_kpe: torch.Tensor, pos: int, *, absorbed: bool = True,
               heads: slice | None = None):
    """One-token decode over the latent cache.  x: (B, 1, E);
    cache_ckv: (B, S, kv_lora); cache_kpe: (B, S, rope_head_dim);
    ``pos`` an int (or a 0-d tensor read once on the host).

    The step's latents are written into the caches in place (the JAX
    function returns updated copies; as ``dynamic_update_slice``, a
    position past the cache writes its last slot) → (y, cache_ckv,
    cache_kpe).  ``heads``: as in :func:`mla_apply`."""
    pos = int(pos)
    dt, dev = x.dtype, x.device
    positions = torch.full((1,), pos, device=dev)
    q = _queries(c, p, x, positions)                       # (B,1,H,qk)
    ckv, kpe = _latents(c, p, x, positions)
    s_cache = cache_ckv.shape[1]
    write = min(max(pos, 0), s_cache - 1)
    cache_ckv[:, write] = ckv[:, 0]
    cache_kpe[:, write] = kpe[:, 0]
    valid = torch.arange(s_cache, device=dev) <= pos
    q_nope, q_pe = q.split([c.nope_head_dim, c.rope_head_dim], dim=-1)
    scale = c.qk_dim ** 0.5

    if absorbed:
        # q ← q·W_uk: (B,1,H,L); scores against the latent cache, each
        # product and the sum and divide in the compute dtype
        q_abs = torch.einsum("bqhd,lhd->bqhl", q_nope, p["w_uk"].to(dt))
        ckv_c = cache_ckv.to(dt)
        scores = (torch.einsum("bqhl,bkl->bhqk", q_abs, ckv_c)
                  + torch.einsum("bqhd,bkd->bhqk", q_pe,
                                 cache_kpe.to(dt))) / scale
        scores = torch.where(valid, scores.float(), -1e30)
        w = torch.softmax(scores, dim=-1).to(dt)
        lat = torch.einsum("bhqk,bkl->bqhl", w, ckv_c)      # (B,1,H,L)
        out = torch.einsum("bqhl,lhd->bqhd", lat, p["w_uv"].to(dt))
    else:
        k, v = _decompress(c, p, cache_ckv, cache_kpe, dt)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
        scores = torch.where(valid, scores.float(), -1e30)
        w = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    out = _mask_heads(c, out, heads)
    return _out_proj(out, p["wo"]), cache_ckv, cache_kpe
