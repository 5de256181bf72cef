"""Shared model machinery (port of ``repro.models.common``): parameter
definitions, norms, rotary embeddings and attention math on tensors.

Every module defines its parameters once as a nested dict of
``ParamDef``; :func:`init_params` materializes tensors from an explicit
``torch.Generator``.  The draws are torch's, not ``jax.random``'s: the
shapes, zeros/ones and scales are the JAX package's, and
:func:`repro_torch.convert.lm_params_from_numpy` carries JAX's own
numbers across where two runs must agree.

Matrix products stay in float32 on the card as on the CPU: the port
never turns TF32 on (``torch.backends.cuda.matmul.allow_tf32`` keeps its
default, False), so a float32 score is a float32 product.

:func:`specs` derives the ``PartitionSpec`` tree from logical-axis
rules, so a sharding change is a rules change, never a model change.
:func:`scan` is a plain Python loop and :func:`unroll_scans` a context
manager that changes nothing (an API difference: JAX's switch makes XLA
unroll its layer scans so cost analysis counts every body; eager torch
runs every iteration anyway, and ``FlopCounterMode`` counts each one).
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch

from repro_torch import tree as _tree
from repro_torch.distributed.sharding import PartitionSpec

__all__ = ["ParamDef", "init_params", "draw_param", "flatten_defs",
           "specs", "count_params", "rms_norm", "rotary", "apply_rope",
           "expand_kv", "attention", "blockwise_attention",
           "DEFAULT_RULES", "scan", "unroll_scans"]


@contextlib.contextmanager
def unroll_scans(kv_block: int | None = 4096):
    """JAX's roofline lowering mode; a no-op here (every loop already
    runs each iteration)."""
    yield


def scan(body, init, xs, **kw):
    """``lax.scan`` as a loop: ``body(carry, x) → (carry, y)`` over the
    leading axis of ``xs`` (a tensor or a tree of them) → ``(carry,
    ys)``, the ``y``s stacked on a new leading axis (``None`` where
    ``body`` returns ``None``)."""
    leaves = _tree.leaves(xs)
    n = leaves[0].shape[0] if leaves else kw.get("length", 0)
    carry, ys = init, []
    for i in range(n):
        x = _tree.unflatten(xs, iter([t[i] for t in leaves]))
        carry, y = body(carry, x)
        ys.append(y)
    if not ys or _tree.leaves(ys[0]) == []:
        return carry, None
    flat = [_tree.leaves(y) for y in ys]
    return carry, _tree.unflatten(ys[0], iter(
        torch.stack(list(col)) for col in zip(*flat)))


class ParamDef(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[Any, ...]            # logical axis name (str) or None per dim
    init: str = "normal"             # normal | zeros | ones
    scale: float | None = None       # stddev; default 1/sqrt(fan_in)


def flatten_defs(defs, prefix: tuple = ()) -> list[tuple[tuple, ParamDef]]:
    """``[(path, ParamDef)]`` in ``jax.tree.flatten`` order (dict keys
    sorted), the order the JAX package draws its per-leaf keys in."""
    if isinstance(defs, ParamDef):
        return [(prefix, defs)]
    out = []
    for k in sorted(defs):
        out.extend(flatten_defs(defs[k], prefix + (k,)))
    return out


def draw_param(d: ParamDef, generator: torch.Generator,
               dtype=torch.float32) -> torch.Tensor:
    """One leaf on ``generator``'s device.  As the JAX package:
    ``fan_in = shape[-2]`` (so ``wq (E, Hq, D)`` scales by ``Hq**-0.5``)."""
    dev = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=dev)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    scale = d.scale if d.scale is not None else fan_in ** -0.5
    # scaled in place: one transient of the leaf's size, not two
    return torch.randn(d.shape, generator=generator, dtype=dtype,
                       device=dev).mul_(scale)


def init_params(defs, generator: torch.Generator, dtype=torch.float32):
    """Materialize a nested dict of ParamDef → tensors, drawn leaf after
    leaf from ``generator`` in ``jax.tree.flatten`` order."""
    out: dict = {}
    for path, d in flatten_defs(defs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = draw_param(d, generator, dtype)
    return out


DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "embed": "data",          # FSDP: weight d_model dim sharded over data
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",      # only when divisible; configs override to None
    "mlp": "model",
    "experts": "model",
    "ssm_inner": "model",
    "layers": None,
    "seq": None,
    "conv": None,
}


def specs(defs, rules: dict[str, Any]):
    """ParamDef tree → PartitionSpec tree via logical-axis rules."""
    if isinstance(defs, ParamDef):
        return PartitionSpec(*(rules.get(a) if a is not None else None
                               for a in defs.axes))
    return {k: specs(v, rules) for k, v in defs.items()}


def count_params(params) -> int:
    """Elements in a nested dict of tensors, or in an ``nn.Module``."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


# ---------------------------------------------------------------------------
# numerics


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def rotary(positions: torch.Tensor, dim: int, theta: float = 1e4):
    """→ (cos, sin), each (..., dim/2), float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2).  Rotate-half
    layout (two halves, not interleaved), float32 arithmetic."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos, sin = cos[..., None, :], sin[..., None, :]   # broadcast over heads
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# attention math (mask kinds: "causal" | "bidir" | windowed / chunked causal)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, kind: str, window: int,
          chunk: int) -> torch.Tensor:
    if kind == "causal":
        m = kpos[None, :] <= qpos[:, None]
    else:
        m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                       device=qpos.device)
    if window:
        m &= kpos[None, :] > (qpos[:, None] - window)
    if chunk:
        m &= (kpos[None, :] // chunk) == (qpos[:, None] // chunk)
    return m


def expand_kv(k: torch.Tensor, rep: int) -> torch.Tensor:
    """GQA: repeat KV heads to the (padded) query head count (each KV
    head ``rep`` times in a row, as ``jnp.repeat``)."""
    return torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              kind: str = "causal", window: int = 0, chunk: int = 0,
              q_offset: int = 0) -> torch.Tensor:
    """Masked MHA/GQA. q: (B,Sq,Hq,D); k/v: (B,Sk,Hkv,D); Hq % Hkv == 0.

    The scores are float32 products of the operands (the JAX package's
    ``preferred_element_type=float32``), then divided by ``sqrt(d)``."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    k = expand_kv(k, hq // hkv)
    v = expand_kv(v, hq // hkv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / (d ** 0.5)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    m = _mask(qpos, kpos, kind, window, chunk)
    scores = torch.where(m[None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return out.reshape(b, sq, hq, dv)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        kind: str = "causal", window: int = 0, chunk: int = 0,
                        kv_block: int = 1024,
                        q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV blocks (flash-style): never holds
    the (Sq, Sk) score matrix, only (B, H, Sq, kv_block).  ``q`` is
    scaled by ``1/sqrt(d)`` in its own dtype, then the block arithmetic
    runs in float32, as in the JAX package."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    k = expand_kv(k, hq // hkv)
    v = expand_kv(v, hq // hkv)
    nblk = -(-sk // kv_block)
    pad = nblk * kv_block - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qh = (q / (d ** 0.5)).float()
    qpos = torch.arange(sq, device=q.device) + q_offset
    acc = torch.zeros((b, hq, sq, dv), dtype=torch.float32, device=q.device)
    m_run = torch.full((b, hq, sq), float("-inf"), dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        kblk = k[:, i * kv_block:(i + 1) * kv_block]
        vblk = v[:, i * kv_block:(i + 1) * kv_block]
        kpos = i * kv_block + torch.arange(kv_block, device=q.device)
        msk = _mask(qpos, kpos, kind, window, chunk) & (kpos < sk)[None, :]
        s = torch.einsum("bqhd,bkhd->bhqk", qh, kblk.float())
        s = torch.where(msk[None, None], s, -1e30)
        m_new = torch.maximum(m_run, s.amax(-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vblk.float())
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)
