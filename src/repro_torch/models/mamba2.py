"""Mamba-2 block (SSD — state-space duality, arXiv:2405.21060), port of
``repro.models.mamba2``.

Training and prefill use the chunked SSD algorithm: the intra-chunk
"attention" term plus the inter-chunk state recurrence (a Python loop
over chunks where JAX has ``lax.scan``).  Decode is the O(1) recurrent
step over the carried ``(conv_state, ssm_state)``.  The SSM state is
float32 whatever the compute dtype.  Single B/C group (ngroups=1), as in
the assigned configs.

``p`` is any mapping of the block's tensors by JAX leaf name
(``in_proj``, ``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``,
``d_skip``, ``norm_w``, ``out_proj``); each is cast at use, as in JAX.

:func:`mamba_apply` and :func:`mamba_decode` are compositions of steps
that a mesh executor (:mod:`.sharded`) calls one at a time on its
member's part: :func:`in_project`, the split, :func:`_causal_conv` /
:func:`conv_step` on any block of channels, :func:`ssd_scan` /
:func:`ssd_step` on any slice of the head dimension ``P`` (the SSD
algebra carries ``p`` through, so a ``P`` slice needs no exchange),
:func:`gate` and :func:`gated_norm` with its sum of squares supplied
from outside, and :func:`out_project`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import ParamDef, rms_norm

__all__ = ["MambaCfg", "mamba_defs", "mamba_apply", "mamba_decode",
           "mamba_init_state", "in_project", "p_channels", "conv_step",
           "ssd_scan", "ssd_step", "gate", "norm_sumsq", "gated_norm",
           "out_project"]


class MambaCfg(NamedTuple):
    d_model: int
    d_state: int = 128        # N
    head_dim: int = 64        # P
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256
    norm_eps: float = 1e-5

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state

    @property
    def d_in_proj(self) -> int:
        return 2 * self.d_inner + 2 * self.d_state + self.n_heads


def mamba_defs(c: MambaCfg) -> dict:
    return {
        "in_proj": ParamDef((c.d_model, c.d_in_proj), ("embed", "ssm_inner")),
        "conv_w": ParamDef((c.conv_dim, c.conv_kernel), ("ssm_inner", "conv"),
                           scale=c.conv_kernel ** -0.5),
        "conv_b": ParamDef((c.conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": ParamDef((c.n_heads,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamDef((c.n_heads,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamDef((c.n_heads,), ("ssm_heads",), init="ones"),
        "norm_w": ParamDef((c.d_inner,), ("ssm_inner",), init="ones"),
        "out_proj": ParamDef((c.d_inner, c.d_model), ("ssm_inner", "embed")),
    }


def in_project(p, xin: torch.Tensor) -> torch.Tensor:
    """The in-projection ``xin @ in_proj`` in ``xin``'s dtype (``p``'s
    ``in_proj`` may be a column block of it)."""
    return xin @ p["in_proj"].to(xin.dtype)


def _split_proj(c: MambaCfg, zxbcdt: torch.Tensor):
    """→ (z, xBC, dt): the in-projection at ``d_inner`` and
    ``d_inner + conv_dim`` (``jnp.split``'s indices)."""
    return torch.split(zxbcdt, [c.d_inner, c.conv_dim,
                                zxbcdt.shape[-1] - c.d_inner - c.conv_dim],
                       dim=-1)


def p_channels(c: MambaCfg, t: torch.Tensor, ps: slice | None,
               inner: bool = False) -> torch.Tensor:
    """The channels of ``t``'s last dimension that the state slice ``ps``
    of every head reads: of a ``conv_dim``-wide tensor (x | B | C) the x
    channels ``(head, p)`` with ``p`` in ``ps``, in that order, then B
    and C whole; with ``inner``, of a ``d_inner``-wide one (x only).
    ``ps=None``: ``t`` itself."""
    if ps is None:
        return t
    lead = t.shape[:-1]
    x = t[..., :c.d_inner].reshape(*lead, c.n_heads, c.head_dim)[..., ps]
    x = x.reshape(*lead, -1)
    return x if inner else torch.cat([x, t[..., c.d_inner:]], -1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(c: MambaCfg, p, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, conv_dim), the taps summed in
    JAX's order, then ``silu(out + conv_b)``."""
    k = c.conv_kernel
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    w = p["conv_w"].to(xbc.dtype)                       # (C, K)
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + s] * w[None, None, :, i]
    return F.silu(out + p["conv_b"].to(xbc.dtype))


def _ssd_chunk_scan(c: MambaCfg, x: torch.Tensor, dt: torch.Tensor,
                    b_in: torch.Tensor, c_in: torch.Tensor, a: torch.Tensor,
                    h0: torch.Tensor):
    """Chunked SSD. x: (B,S,H,P); dt: (B,S,H); b/c: (B,S,N); a: (H,) < 0.

    ``S`` must be a multiple of ``min(chunk, S)`` (:func:`mamba_apply`
    pads).  Returns (y (B,S,H,P) float32, h_final (B,H,P,N) float32).
    """
    bsz, s, h, pdim = x.shape
    q = min(c.chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    h_prev, ys = h0, []
    for i in range(s // q):
        sl = slice(i * q, (i + 1) * q)
        xk, dtk, bk, ck = x[:, sl], dt[:, sl], b_in[:, sl], c_in[:, sl]
        dta = dtk.float() * a                               # (B,Q,H) <= 0
        cum = torch.cumsum(dta, dim=1)                      # (B,Q,H)
        bx = dtk[..., None].float() * xk.float()            # (B,Q,H,P)
        # intra-chunk: decay matrix (B,Q,K,H), causal.  Masked before the
        # exp: the values of the reference's where(tri, exp(li), 0), whose
        # backward is NaN where exp(li) overflows above the diagonal
        # (ROADMAP.md, R11)
        li = cum[:, :, None] - cum[:, None]                 # (B,Q,K,H)
        dec = torch.exp(torch.where(tri[None, :, :, None], li,
                                    float("-inf")))
        cb = torch.einsum("bqn,bkn->bqk", ck.float(), bk.float())
        y_intra = torch.einsum("bqk,bqkh,bkhp->bqhp", cb, dec, bx)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("bqn,bhpn->bqhp", ck.float(), h_prev) \
            * torch.exp(cum)[..., None]
        # next state
        dec_end = torch.exp(cum[:, -1:, :] - cum)           # (B,K,H)
        s_chunk = torch.einsum("bkh,bkhp,bkn->bhpn", dec_end, bx, bk.float())
        h_prev = torch.exp(cum[:, -1])[..., None, None] * h_prev + s_chunk
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h_prev


def conv_step(c: MambaCfg, p, conv_state: torch.Tensor,
              xbc_new: torch.Tensor):
    """The decode conv on any block of channels: the window ``conv_state``
    (B, C', K−1) ++ the new sample ``xbc_new`` (B, C') → (``silu(window ·
    conv_w + conv_b)`` (B, C'), the next window (B, C', K−1)); ``p``'s
    ``conv_w`` / ``conv_b`` are that block's."""
    win = torch.cat([conv_state, xbc_new[:, :, None]], -1)    # (B,C,K)
    w = p["conv_w"].to(xbc_new.dtype)
    out = F.silu((win * w[None]).sum(-1) + p["conv_b"].to(xbc_new.dtype))
    return out, win[:, :, 1:]


def ssd_scan(c: MambaCfg, p, x: torch.Tensor, dt_raw: torch.Tensor,
             b_in: torch.Tensor, c_in: torch.Tensor,
             h0: torch.Tensor | None = None):
    """The SSM over a whole sequence on any slice ``P'`` of the head
    dimension (every einsum carries ``p`` through): x (B, S, H, P'),
    dt_raw (B, S, H), b/c (B, S, N) → (y + D·x (B, S, H, P') float32,
    h_final (B, H, P', N) float32)."""
    bsz, s, h, pdim = x.shape
    dt = _softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    if h0 is None:
        h0 = torch.zeros((bsz, h, pdim, c.d_state), dtype=torch.float32,
                         device=x.device)
    # pad to a chunk multiple; dt=0 on padding => identity state update
    q = min(c.chunk, s)
    sp = -(-s // q) * q
    if sp != s:
        y, h_final = _ssd_chunk_scan(
            c, F.pad(x, (0, 0, 0, 0, 0, sp - s)), F.pad(dt, (0, 0, 0, sp - s)),
            F.pad(b_in, (0, 0, 0, sp - s)), F.pad(c_in, (0, 0, 0, sp - s)),
            a, h0)
        y = y[:, :s]
    else:
        y, h_final = _ssd_chunk_scan(c, x, dt, b_in, c_in, a, h0)
    return y + p["d_skip"].float()[None, None, :, None] * x.float(), h_final


def ssd_step(c: MambaCfg, p, x: torch.Tensor, dt_raw: torch.Tensor,
             b_in: torch.Tensor, c_in: torch.Tensor, state: torch.Tensor):
    """The recurrent step on any slice ``P'``: x (B, H, P'), dt_raw (B, H),
    b/c (B, N), state (B, H, P', N) float32 → (y + D·x (B, H, P')
    float32, state')."""
    x = x.float()
    dt = _softplus(dt_raw.float() + p["dt_bias"].float())      # (B,H)
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt * a)                                  # (B,H)
    bx = torch.einsum("bh,bhp,bn->bhpn", dt, x, b_in.float())
    state = decay[..., None, None] * state + bx
    y = torch.einsum("bn,bhpn->bhp", c_in.float(), state)
    return y + p["d_skip"].float()[None, :, None] * x, state


def gate(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``y · silu(z)``, the gated norm's input."""
    return y * F.silu(z)


def norm_sumsq(g: torch.Tensor) -> torch.Tensor:
    """The float32 sum of squares over ``g``'s last dimension (keepdim):
    a slice's part of the gated norm's statistic."""
    g = g.float()
    return (g * g).sum(-1, keepdim=True)


def gated_norm(c: MambaCfg, g: torch.Tensor, norm_w: torch.Tensor,
               sumsq: torch.Tensor | None = None) -> torch.Tensor:
    """RMSNorm of the gated ``g`` over ``d_inner`` with weight ``norm_w``
    (``g``'s channels); ``sumsq``: the sum of squares over all
    ``d_inner`` channels, computed outside (``g`` then holds a slice of
    them), else ``rms_norm`` itself."""
    if sumsq is None:
        return rms_norm(g, norm_w, c.norm_eps)
    x = g.float() * torch.rsqrt(sumsq / c.d_inner + c.norm_eps)
    return (x * norm_w.float()).to(g.dtype)


def out_project(p, y: torch.Tensor) -> torch.Tensor:
    """``y @ out_proj`` (``p``'s ``out_proj`` may be a row block)."""
    return y @ p["out_proj"].to(y.dtype)


def mamba_apply(c: MambaCfg, p, xin: torch.Tensor, *,
                h0: torch.Tensor | None = None):
    """Full-sequence forward. xin: (B, S, E) → (y (B,S,E), (conv_state,
    h_final)): ``conv_state`` the last ``K−1`` pre-activation conv inputs
    (B, conv_dim, min(K−1, S)) for decode to continue from, ``h_final``
    (B, H, P, N) float32."""
    bsz, s, _ = xin.shape
    zxbcdt = in_project(p, xin)
    z, xbc, dt_raw = _split_proj(c, zxbcdt)
    xbc = _causal_conv(c, p, xbc)
    x, b_in, c_in = torch.split(xbc, [c.d_inner, c.d_state, c.d_state], -1)
    x = x.reshape(bsz, s, c.n_heads, c.head_dim)
    y, h_final = ssd_scan(c, p, x, dt_raw, b_in, c_in, h0)
    y = y.reshape(bsz, s, c.d_inner).to(xin.dtype)
    y = gated_norm(c, gate(y, z), p["norm_w"])
    # last K-1 pre-activation conv inputs (for decode continuation)
    conv_state = zxbcdt[:, -(c.conv_kernel - 1):,
                        c.d_inner:c.d_inner + c.conv_dim].transpose(1, 2)
    return out_project(p, y), (conv_state, h_final)


def mamba_init_state(c: MambaCfg, batch: int, dtype=torch.bfloat16,
                     device=None):
    """Zeroed ``(conv_state (B, conv_dim, K−1) in dtype, ssm_state
    (B, H, P, N) float32)``."""
    conv_state = torch.zeros((batch, c.conv_dim, c.conv_kernel - 1),
                             dtype=dtype, device=device)
    ssm_state = torch.zeros((batch, c.n_heads, c.head_dim, c.d_state),
                            dtype=torch.float32, device=device)
    return conv_state, ssm_state


def mamba_decode(c: MambaCfg, p, xin: torch.Tensor, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor):
    """One-token recurrent step. xin: (B, 1, E) → (y (B,1,E), conv_state',
    ssm_state'), new tensors (the caller's are not written)."""
    bsz = xin.shape[0]
    zxbcdt = in_project(p, xin[:, 0])                         # (B, dproj)
    z, xbc_new, dt_raw = _split_proj(c, zxbcdt)
    xbc, conv_state = conv_step(c, p, conv_state, xbc_new)
    x, b_in, c_in = torch.split(xbc, [c.d_inner, c.d_state, c.d_state], -1)
    x = x.reshape(bsz, c.n_heads, c.head_dim)
    y, ssm_state = ssd_step(c, p, x, dt_raw, b_in, c_in, ssm_state)
    y = y.reshape(bsz, 1, c.d_inner).to(xin.dtype)
    y = gated_norm(c, gate(y, z[:, None]), p["norm_w"])
    return out_project(p, y), conv_state, ssm_state
