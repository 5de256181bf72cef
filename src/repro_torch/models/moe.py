"""Mixture-of-Experts FFN (port of ``repro.models.moe``): the SwiGLU MLP
(also the shared expert and the dense-layer FFN) and the routed experts
of llama4-scout (16 experts, top-1, one shared expert) and deepseek-v2
(160 experts, top-6, two shared experts fused).

``moe_apply`` is the reference's function, not a faster one: softmax
gates in float32, top-k renormalized, tokens grouped by expert with a
stable sort, a per-expert capacity of ``int(max(1, 1.25·T·k/E))`` slots
over ``T = B·S`` tokens (so a decode step at B=8 keeps one token an
expert: ROADMAP.md, R7), the expert products over the whole
``(E, cap, d_model)`` buffer, and the gated combine.  Three places where
torch's defaults differ from JAX's are pinned to JAX's:

- top-k ties go to the lower expert index (``jax.lax.top_k``):
  ``torch.topk`` promises no order, so a stable descending sort is cut
  to k;
- the grouping sort is stable (``jnp.argsort``);
- the combine sums each token's k weighted slots in a fixed order,
  ascending expert id from zero (the stable sort's order, which XLA's
  CPU scatter applies), with no atomics: ``index_add_`` on CUDA would
  sum them in no fixed order and could move a greedy pick between runs.

``moe_apply`` takes the JAX function's sharding hooks: ``dp_groups`` is
ignored (as in JAX), and ``constrain(t, *logical_axes)`` is called on the
token rows, the dispatched rows, the expert buffer, the experts' hidden
and output buffers and the combined slots and tokens, in the JAX
function's order, its result used where it is a tensor (the port's ``LM`` constrainer returns the
resolved ``NamedSharding`` and moves nothing).  On a mesh the moe family runs through
:class:`~repro_torch.models.sharded.LMMesh`: routing once over the global
tokens (:func:`moe_route`), each ``model`` member's block of experts
(:func:`expert_ffn` over its ``(E/tp, cap, d)`` buffer), and the combine
in :func:`combine_order`'s order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .common import ParamDef

__all__ = ["MoECfg", "Routing", "moe_defs", "moe_route", "moe_apply",
           "expert_ffn", "combine_order", "mlp_defs", "mlp_apply"]


class MoECfg(NamedTuple):
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int                 # per-expert hidden
    n_shared: int = 0
    shared_d_ff: int = 0      # hidden of the fused shared expert(s)
    capacity_factor: float = 1.25


# -- dense SwiGLU MLP (also the shared expert / dense-layer FFN) -------------


def mlp_defs(d_model: int, d_ff: int) -> dict:
    return {
        "w1": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w3": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w2": ParamDef((d_ff, d_model), ("mlp", "embed")),
    }


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``silu(x @ w1) * (x @ w3) @ w2`` in ``x``'s dtype."""
    dt = x.dtype
    h = torch.nn.functional.silu(x @ p["w1"].to(dt)) * (x @ p["w3"].to(dt))
    return h @ p["w2"].to(dt)


# -- routed experts -----------------------------------------------------------


def moe_defs(c: MoECfg) -> dict:
    e, f = c.d_model, c.d_ff
    defs = {
        "router": ParamDef((e, c.n_experts), ("embed", None), scale=0.02),
        "w1": ParamDef((c.n_experts, e, f), ("experts", "embed", "expert_mlp")),
        "w3": ParamDef((c.n_experts, e, f), ("experts", "embed", "expert_mlp")),
        "w2": ParamDef((c.n_experts, f, e), ("experts", "expert_mlp", "embed")),
    }
    if c.n_shared:
        defs["shared"] = mlp_defs(e, c.shared_d_ff or f * c.n_shared)
    return defs


class Routing(NamedTuple):
    """One ``moe_apply`` call's routing over its ``T`` tokens."""
    gates: torch.Tensor       # (T, E) float32 softmax
    top_w: torch.Tensor       # (T, k) float32, renormalized
    top_i: torch.Tensor       # (T, k) expert ids, best first
    cap: int                  # slots per expert
    order: torch.Tensor       # (T·k,) stable sort of the flat expert ids
    sorted_e: torch.Tensor    # (T·k,) expert id of each sorted entry
    slot: torch.Tensor        # (T·k,) its slot in the expert's bucket
    keep: torch.Tensor        # (T·k,) bool: slot < cap


def moe_route(c: MoECfg, router: torch.Tensor, xt: torch.Tensor) -> Routing:
    """Gates, top-k and bucket slots of tokens ``xt`` (T, d_model): the
    router product in ``xt``'s dtype, then float32."""
    t = xt.shape[0]
    logits = (xt @ router.to(xt.dtype)).float()
    gates = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: descending, ties to the lower index
    srt = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_i = srt.values[:, :c.top_k], srt.indices[:, :c.top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    cap = int(max(1, c.capacity_factor * t * c.top_k / c.n_experts))
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)            # group by expert
    sorted_e = flat_e[order]
    counts = torch.bincount(sorted_e, minlength=c.n_experts)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(t * c.top_k, device=xt.device) - starts[sorted_e]
    return Routing(gates, top_w, top_i, cap, order, sorted_e, slot,
                   slot < cap)


def expert_ffn(p, buf: torch.Tensor, hook=None) -> torch.Tensor:
    """The routed experts' SwiGLU over their buckets: ``buf`` (E, cap, d)
    against ``p["w1"]`` / ``p["w3"]`` (E, d, f) and ``p["w2"]`` (E, f,
    d), one batched product each, in ``buf``'s dtype (``hook``: applied
    to the hidden (E, cap, f), as ``moe_apply``'s ``constrain``)."""
    dt = buf.dtype
    h = torch.nn.functional.silu(torch.bmm(buf, p["w1"].to(dt))) * \
        torch.bmm(buf, p["w3"].to(dt))
    if hook is not None:
        h = hook(h, "experts", None, None)
    return torch.bmm(h, p["w2"].to(dt))


def combine_order(r: Routing) -> torch.Tensor:
    """(T, k): each token's k entries as positions in the sorted order,
    ascending (= ascending expert id): the combine adds them one after
    another from zero in this order."""
    pos = torch.empty_like(r.order)
    pos[r.order] = torch.arange(r.order.numel(), device=r.order.device)
    return pos.reshape(r.top_i.shape).sort(dim=-1).values


def moe_apply(c: MoECfg, p, x: torch.Tensor, constrain=None,
              dp_groups: int = 1) -> torch.Tensor:
    """x: (B, S, d_model) → (B, S, d_model) in ``x``'s dtype.  Tokens
    past their expert's capacity get no routed output (the shared
    experts still apply).  ``constrain`` / ``dp_groups``: the JAX
    function's sharding hooks (the module docstring)."""
    del dp_groups

    def hook(t, *axes):
        got = constrain(t, *axes) if constrain is not None else None
        return got if isinstance(got, torch.Tensor) else t
    b, s, e = x.shape
    t, k, dt = b * s, c.top_k, x.dtype
    xt = hook(x.reshape(t, e), "tokens", None)
    r = moe_route(c, p["router"], xt)
    src_tok = r.order // k
    e_idx = torch.where(r.keep, r.sorted_e, 0)
    s_idx = torch.where(r.keep, r.slot, 0)

    # dropped entries add a zero row at (0, 0), as the reference does
    dispatched = hook(torch.where(r.keep[:, None], xt[src_tok], 0).to(dt),
                      "tokens", None)
    buf = torch.zeros((c.n_experts, r.cap, e), dtype=dt, device=x.device)
    buf.index_put_((e_idx, s_idx), dispatched, accumulate=True)
    out_buf = hook(expert_ffn(p, hook(buf, "experts", None, None), hook),
                   "experts", None, None)                 # (E, cap, e)

    w_slots = r.top_w.reshape(-1)[r.order]
    y_slots = hook(torch.where(r.keep[:, None], out_buf[e_idx, s_idx]
                               * w_slots[:, None].to(dt), 0),
                   "tokens", None)
    # each token's k entries summed one after another from zero
    pos = combine_order(r)
    yt = torch.zeros((t, e), dtype=dt, device=x.device)
    for j in range(k):
        yt = yt + y_slots[pos[:, j]]
    yt = hook(yt, "tokens", None)

    if c.n_shared:
        yt = yt + mlp_apply(p["shared"], xt)
    return yt.reshape(b, s, e)
