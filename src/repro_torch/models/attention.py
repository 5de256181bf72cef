"""GQA/MHA attention block with RoPE, optional QKV bias, sliding-window and
chunked-local variants, and a decode path over (ring-buffer) KV caches
(port of ``repro.models.attention``).

Head padding for tensor parallelism: the *parameter* head count is
padded so it divides ``tp``, within each KV group (layout ``(hkv,
rep)``), and a head mask zeroes the padded heads after attention.
:class:`AttnCfg`'s arithmetic is the JAX package's, digit for digit, so
a parameter tree the JAX ``LM`` made at any ``tp`` carries across and
computes the same (including the reference's quirk where KV padding
drops query heads: ROADMAP.md, R4).

``p`` is any mapping of the block's tensors by JAX leaf name (``wq``,
``wk``, ``wv``, ``wo`` and, with ``qkv_bias``, ``bq``, ``bk``, ``bv``):
a dict, or the module an :class:`~.model.LM` layer holds its
parameters in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .common import (ParamDef, apply_rope, attention, blockwise_attention,
                     expand_kv, rotary)

__all__ = ["AttnCfg", "attn_defs", "attn_apply", "attn_decode",
           "decode_slot", "decode_valid", "pad_heads", "BLOCKWISE_THRESHOLD"]

BLOCKWISE_THRESHOLD = 8192   # use online-softmax blocks above this KV length


def pad_heads(n: int, tp: int) -> int:
    """Round head count up to a multiple of tp."""
    return -(-n // tp) * tp


class AttnCfg(NamedTuple):
    d_model: int
    n_heads: int          # true (unpadded) query heads
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: int = 0       # sliding window (starcoder2)
    chunk: int = 0        # chunked local attention (llama4)
    use_rope: bool = True
    tp: int = 16          # model-axis size used for head padding

    @property
    def g(self) -> int:    # true q heads per kv group
        assert self.n_heads % self.n_kv_heads == 0
        return self.n_heads // self.n_kv_heads

    @property
    def hkv(self) -> int:  # effective kv heads (padded only if needed)
        if self.n_kv_heads % self.tp == 0 or self.tp % self.n_kv_heads == 0:
            return self.n_kv_heads
        return pad_heads(self.n_kv_heads, self.tp)

    @property
    def rep(self) -> int:  # padded group size: smallest r>=g with hkv·r % tp == 0
        r = max(1, self.g if self.hkv == self.n_kv_heads else 1)
        while (self.hkv * r) % self.tp:
            r += 1
        return r

    @property
    def hq(self) -> int:   # effective (padded) query heads
        return self.hkv * self.rep

    def head_mask(self, device=None) -> torch.Tensor:
        """(hkv, rep) bool — True for real heads."""
        kv_ok = torch.arange(self.hkv, device=device) < self.n_kv_heads
        g_ok = torch.arange(self.rep, device=device) < self.g
        return kv_ok[:, None] & g_ok[None, :]


def attn_defs(c: AttnCfg) -> dict:
    e, hq, hkv, d = c.d_model, c.hq, c.hkv, c.head_dim
    defs = {
        "wq": ParamDef((e, hq, d), ("embed", "heads", None)),
        "wk": ParamDef((e, hkv, d), ("embed", "kv_heads", None)),
        "wv": ParamDef((e, hkv, d), ("embed", "kv_heads", None)),
        "wo": ParamDef((hq, d, e), ("heads", None, "embed")),
    }
    if c.qkv_bias:
        defs.update({
            "bq": ParamDef((hq, d), ("heads", None), init="zeros"),
            "bk": ParamDef((hkv, d), ("kv_heads", None), init="zeros"),
            "bv": ParamDef((hkv, d), ("kv_heads", None), init="zeros"),
        })
    return defs


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bse,ehd->bshd")`` as one matrix product in ``x``'s dtype."""
    b, s, e = x.shape
    _, h, d = w.shape
    return (x @ w.to(x.dtype).reshape(e, h * d)).view(b, s, h, d)


def _project_qkv(c: AttnCfg, p, x: torch.Tensor, positions: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if c.qkv_bias:      # added after the product is rounded, as in JAX
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if c.use_rope:
        cos, sin = rotary(positions, c.head_dim, c.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _mask_heads(c: AttnCfg, out: torch.Tensor,
                heads: slice | None = None) -> torch.Tensor:
    """Zero padded heads. out: (B, S, hq, D) laid out as (hkv, rep), or
    the query heads ``heads`` of them."""
    if c.hq == c.n_heads:
        return out
    m = c.head_mask(out.device).reshape(c.hq)
    if heads is not None:
        m = m[heads]
    return out * m.reshape(1, 1, -1, 1).to(out.dtype)


def _kv_for(c: AttnCfg, q: torch.Tensor, k: torch.Tensor,
            heads: slice | None) -> torch.Tensor:
    """Keys or values for the query heads ``q`` holds: on a mesh whose
    model extent does not divide the KV heads, a member holds every KV
    head and computes only its query heads ``heads``, so the KV heads
    are repeated to the full query count and cut to that range."""
    if heads is None or k.shape[2] * c.rep == q.shape[2]:
        return k
    return expand_kv(k, c.rep)[:, :, heads]


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshd,hde->bse")`` as one matrix product."""
    b, s, h, d = out.shape
    return out.reshape(b, s, h * d) @ wo.to(out.dtype).reshape(h * d, -1)


def attn_apply(c: AttnCfg, p, x: torch.Tensor, *, kind: str = "causal",
               q_offset: int = 0,
               heads: slice | None = None) -> tuple[torch.Tensor, tuple]:
    """Full-sequence attention (prefill). x: (B, S, E).

    Returns (y, (k, v)) so prefill can emit the KV cache.  On a mesh,
    ``p`` holds one member's heads (the query heads ``heads`` of the
    padded ``hq``) and ``y`` is its partial output projection.
    """
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device) + q_offset
    q, k, v = _project_qkv(c, p, x, positions)
    fn = blockwise_attention if s > BLOCKWISE_THRESHOLD else attention
    out = fn(q, _kv_for(c, q, k, heads), _kv_for(c, q, v, heads),
             kind=kind, window=c.window, chunk=c.chunk, q_offset=q_offset)
    out = _mask_heads(c, out, heads)
    return _out_proj(out, p["wo"]), (k, v)


def decode_slot(c: AttnCfg, s_cache: int, pos: int) -> int:
    """The cache slot a decode step at ``pos`` writes: ``pos % s_cache``
    for a ring buffer, else ``pos``; clamped into the cache as
    ``jax.lax.dynamic_update_slice`` clamps its index."""
    slot = pos % s_cache if (c.window or c.chunk) else pos
    return min(max(slot, 0), s_cache - 1)


def decode_valid(c: AttnCfg, s_cache: int, pos: int,
                 idx: torch.Tensor) -> torch.Tensor:
    """Which cache slots ``idx`` (indices into a cache of ``s_cache``
    slots; a member of a length-sharded cache passes its own) a decode
    step at ``pos`` attends to: ``idx <= pos``, or for a ring buffer
    (window / chunk) the slots whose stored absolute position a full
    cache would have kept."""
    if not (c.window or c.chunk):
        return idx <= pos
    slot = pos % s_cache
    # absolute position stored in each ring slot
    abs_pos = torch.where(idx <= slot, pos - (slot - idx),
                          pos + (idx - slot) - s_cache)
    if c.chunk:
        start = (pos // c.chunk) * c.chunk
        return (abs_pos >= start) & (abs_pos <= pos) & (abs_pos >= 0)
    return (abs_pos > pos - c.window) & (abs_pos <= pos) & (abs_pos >= 0)


def attn_decode(c: AttnCfg, p, x: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: int, heads: slice | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, E); cache: (B, S_cache, hkv, D) holding
    rotated keys; ``pos``: current absolute position (an int, or a 0-d
    tensor read once on the host).

    The new key and value are written into ``cache_k`` / ``cache_v`` in
    place (the JAX function returns updated copies); both are returned.
    Sliding-window / chunked layers use a ring buffer of size
    ``S_cache ∈ {window, chunk}`` — write index ``pos % S_cache``; masking
    keeps exactly the positions a full cache would have kept.  As
    ``jax.lax.dynamic_update_slice``, a write index past the cache clamps
    to its last slot (the mask still uses the unclamped index).
    ``heads``: as in :func:`attn_apply` (the cache holds the member's
    KV heads).
    """
    pos = int(pos)
    s_cache = cache_k.shape[1]
    dev = x.device
    # a fill on the device: torch.tensor([pos]) would copy from the host
    # and wait for the stream
    q, k, v = _project_qkv(c, p, x, torch.full((1,), pos, device=dev))
    write = decode_slot(c, s_cache, pos)
    cache_k[:, write] = k[:, 0]
    cache_v[:, write] = v[:, 0]

    valid = decode_valid(c, s_cache, pos, torch.arange(s_cache, device=dev))
    ke = expand_kv(cache_k, c.rep)
    ve = expand_kv(cache_v, c.rep)
    if ke.shape[2] != q.shape[2]:   # every KV head held: cut to ``heads``
        ke, ve = ke[:, :, heads], ve[:, :, heads]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), ke.float()) \
        / (c.head_dim ** 0.5)
    scores = torch.where(valid[None, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, ve)
    out = _mask_heads(c, out, heads)
    return _out_proj(out, p["wo"]), cache_k, cache_v
