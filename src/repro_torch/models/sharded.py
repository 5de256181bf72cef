"""Every LM family over a device mesh: what GSPMD does with the LM's
specs, written out for a single process (the port's counterpart
of ``jax.jit`` with ``param_shardings`` / ``input_shardings`` on a
``("data", "model")`` or ``("pod", "data", "model")`` mesh).

Every member of ``lm.mesh`` holds only its shards (``lm.params`` leaves
are :class:`~repro_torch.distributed.sharding.ShardedTensor`\\ s) and
computes on its own device; one thread launches each member's work in
turn, so a mesh that repeats one device runs its members one after
another (more launches and copies, no speedup).  The model is a list of
:class:`Unit`\\ s: attention + FFN layers (a dense layer; a llama4
chunked-local or global NoPE layer, in superblock order; a deepseek MLA
layer, the dense first one then the MoE ones; zamba2's shared block at
each superblock; seamless's bidirectional encoder layers, over the
frames, and its decoder layers with a cross-attention between the
halves) and mamba layers.  Per unit:

- the batch rows are split over the ``pod`` / ``data`` members where
  the batch divides their extent (:func:`batch_axes`), else every
  member holds them all;
- a leaf whose ``embed`` dimension is split over ``data`` (FSDP) is
  gathered across the data members of its model column before use: a
  bitwise ``.to()`` and a concatenation in member order
  (:class:`_Gather`, whose backward sums the members' gradients of each
  slice in member order: the reduce-scatter);
- each ``model`` member computes its query heads (heads are padded to
  ``tp``), their keys and values (all KV heads where the model extent
  does not divide them: the spec keeps them replicated) or MLA's
  latents (every member: ``w_dq`` / ``w_dkv`` / ``w_kpe`` carry no head
  axis), the attention over them and its partial output projection; the
  SwiGLU MLP (and a MoE layer's shared experts) its columns of ``w1`` /
  ``w3`` and rows of ``w2``.  The partials are summed in fixed member
  order on each member (:class:`_AllReduce`);
- routed experts (:meth:`LMMesh.moe`): the token rows are gathered in
  batch order onto the first member, which routes them once
  (``moe_route`` over the global ``T = B·S``, so the capacity and the
  tokens it drops are the unsharded ones, R7); the routing is copied to
  the others.  Each ``model`` member holds a contiguous block of ``E/tp``
  experts and fills their ``(E/tp, cap, d)`` buffer with ``.to()``
  copies of the rows from the members that own them; after its
  experts' products it adds its entries of each token, in ascending
  expert id, onto a running sum passed from member to member in model
  order (the unsharded combine's order, addition for addition), and the
  last member's sum is copied to the others;
- a mamba layer (:meth:`LMMesh._mamba`): each ``model`` member computes
  its column block of ``in_proj``'s product and the blocks are gathered
  (they straddle z | xBC | dt), the per-channel leaves are gathered
  whole; each member runs the conv, the SSD scan or recurrence and the
  gate on its slice of the head dimension ``P`` (the SSM state's and the
  conv state's slices are the cache spec's, so the states never move
  between steps), the norm's sum of squares is summed over the ``P``
  slices in member order, and each member's ``out_proj`` row block takes
  its channels from the other slices before its partial product, summed
  over ``model``;
- a decoder layer's cross-attention: each member its query heads and
  their keys and values from the encoder's output; a decode step reads
  the cache's ``xk`` / ``xv`` under their spec and never writes them
  (R6);
- a decode cache whose spec shards its length (``kv_seq``, or the data
  axes for a batch that cannot be split) runs sequence-parallel: each
  member scores its slice of the cache for the query heads of its length
  group (gathered from the group's members where they differ), the
  group takes the maximum, sums the ``exp(s − max)`` terms in member
  order, normalizes and casts as ``jax.nn.softmax`` does, and sums each
  member's ``w·v`` partial in member order; only the member whose slice
  holds the written slot writes the new entry.  A cache whose stored
  spec is not the one the executor works in (the JAX rule takes the
  first dimension equal to the batch, which can be a stacking axis) is
  gathered into the working layout for the step and scattered back;
- the embedding lookup and the head are split over ``vocab``: each
  member looks up the tokens in its rows (the others give zeros, summed
  as above); the served token is the tournament argmax of the members'
  tournament picks (the first maximum wins, as
  ``core.popcount.argmax_tournament``); the loss combines the members'
  sums of ``exp(logits − max)`` and target logits in fixed order, as
  the vocab-sharded cross entropy of the JAX ``LM.loss`` does.

Gradients (every family): each member's view of a stacked leaf is a
parameter whose ``.grad`` views that member's shard of ``lm.grads``.
Every exchange above is differentiable and its backward sums in fixed
member order, so two backward passes on the same inputs give the same
bits: a gather's backward sums the members' gradients of each slice
(the FSDP reduce-scatter; a mamba layer's ``in_proj`` blocks and its
per-channel leaves gathered whole), a partial sum's backward is the
same sum (the norm's sum of squares over the ``P`` slices, ``out_proj``'s
row blocks, the attention and MLP halves), and a ``.to()`` copy's sends
the gradient back to its source (a MoE layer's rows into the lead
member's routing and into the expert blocks, the running combine from
member to member back to the expert outputs and the gates).  A
replicated activation's gradient on each member is a partial: the
member's own uses of it.  Only the lead member's router view takes the
routing's gradient (the others' copies get none), dropped capacity
slots take none, and zamba2's shared block sums its sites' gradients
into one set of views.  After the backward pass
:meth:`LMMesh.reduce_grads` sums the copies of a replicated slice in
member order (norm weights, routers, replicated KV projections).  With
``remat`` each unit that the JAX package's ``_maybe_remat`` wraps runs
under a reentrant checkpoint (:meth:`LMMesh._run`), the encoder's too.
"""

from __future__ import annotations

import weakref
from typing import Any, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.popcount import argmax_tournament
from repro_torch.distributed.sharding import (NamedSharding, PartitionSpec,
                                              ShardedTensor, _names,
                                              batch_axes)
from repro_torch.tree import leaves as _leaves

from .attention import _mask_heads as _attn_mask_heads
from .attention import (_kv_for, _out_proj, _proj, _project_qkv,
                        attn_apply, attn_decode, decode_slot, decode_valid)
from .common import attention, expand_kv, rms_norm
from .mamba2 import (_causal_conv, _split_proj, conv_step, gate, gated_norm,
                     in_project, norm_sumsq, out_project, p_channels,
                     ssd_scan, ssd_step)
from .mla import _mask_heads as _mla_mask_heads
from .mla import MLACfg, _latents, _queries, mla_apply, mla_decode
from .moe import combine_order, expert_ffn, mlp_apply, moe_route

__all__ = ["LMMesh", "Unit", "units"]


class Unit(NamedTuple):
    """One layer of the model, in forward order: an attention + FFN
    layer (``kind`` ``"attn"``; ``"enc"``: bidirectional, over the
    encoder's stream; ``"dec"``: a cross-attention over the encoder's
    output between the two halves) or a mamba layer (``"mamba"``)."""
    prefix: tuple   # its leaves' path: ("layers",), ("blocks", "local"), ...
    idx: tuple      # its index into their stacked axes
    attn: Any       # its AttnCfg or MLACfg; a mamba layer's MambaCfg
    ffn: str        # "mlp", "moe"; "" for a mamba layer
    site: tuple     # its decode-cache subtree: (), ("local",), ("rest",), ...
    kind: str = "attn"
    cache_at: tuple | None = None   # its index into the cache's stacked
    # axes, where it is not ``idx`` (zamba2's shared block: superblock s)
    remat: bool = True  # checkpointed when the model remats, as the JAX
    # package's scanned layers (deepseek's unscanned first layer: not)

    @property
    def cidx(self) -> tuple:
        return self.idx if self.cache_at is None else self.cache_at


def units(lm) -> list[Unit]:
    """The units of an ``LM`` of any family, in forward order (encdec:
    the encoder's, then the decoder's)."""
    c = lm.cfg
    if c.family == "dense":
        return [Unit(("layers",), (i,), lm.attn_cfg, "mlp", ())
                for i in range(c.n_layers)]
    if c.family == "moe" and not c.use_mla:       # llama4 superblocks
        out = []
        for s in range(c.n_layers // c.global_every):
            out += [Unit(("blocks", "local"), (s, j), lm.attn_local, "moe",
                         ("local",)) for j in range(c.global_every - 1)]
            out.append(Unit(("blocks", "global"), (s,), lm.attn_global,
                            "moe", ("global",)))
        return out
    if c.family == "moe":                         # deepseek
        return [Unit(("first",), (), lm.mla_cfg, "mlp", ("first",),
                     remat=False)] + \
            [Unit(("layers",), (i,), lm.mla_cfg, "moe", ("rest",))
             for i in range(c.n_layers - c.first_dense)]
    if c.family == "ssm":
        return [Unit(("layers",), (i,), lm.mamba_cfg, "", (), "mamba")
                for i in range(c.n_layers)]
    if c.family == "hybrid":                      # zamba2 superblocks
        out = []
        for s in range(c.n_layers // c.shared_attn_every):
            out += [Unit(("blocks",), (s, j), lm.mamba_cfg, "", (), "mamba")
                    for j in range(c.shared_attn_every)]
            out.append(Unit(("shared",), (), lm.attn_cfg, "mlp", ("attn",),
                            "attn", (s,)))
        return out
    if c.family == "encdec":
        return [Unit(("encoder",), (i,), lm.attn_cfg, "mlp", (), "enc")
                for i in range(c.n_enc_layers)] + \
            [Unit(("layers",), (i,), lm.attn_cfg, "mlp", (), "dec")
             for i in range(c.n_layers)]
    raise ValueError(f"{c.name}: no mesh units for the {c.family} family")


def _cache_names(u: Unit) -> tuple:
    """The decode-cache leaves unit ``u`` reads, under ``u.site``."""
    if u.kind == "enc":
        return ()
    if u.kind == "mamba":
        return ("conv", "ssm")
    if isinstance(u.attn, MLACfg):
        return ("ckv", "kpe")
    return ("k", "v", "xk", "xv") if u.kind == "dec" else ("k", "v")


# cache leaves a decode step reads and never writes (R6)
READ_ONLY = ("xk", "xv")


def _get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _cross_attend(c, p, h: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  heads) -> torch.Tensor:
    """One member's cross-attention for its query heads ``heads`` over
    keys ``k`` and values ``v`` (its KV heads, or all of them) → its
    partial output projection; no RoPE, biases or head mask, as the
    unsharded layer."""
    q = _proj(h, p["wq"])
    out = attention(q, _kv_for(c, q, k, heads), _kv_for(c, q, v, heads),
                    kind="bidir")
    return _out_proj(out, p["wo"])


def _fixed_sum(parts: list, device) -> torch.Tensor:
    """``parts[0] + parts[1] + …`` on ``device``, in list order."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


class _Gather(torch.autograd.Function):
    """``shards`` (a gather group, in block order) concatenated along
    ``dim`` onto each of ``devices`` → one gathered tensor per device.
    Backward: each shard's gradient is the sum, in output order, of the
    outputs' gradients at its slice."""

    @staticmethod
    def forward(ctx, dim, devices, *shards):
        ctx.set_materialize_grads(False)
        ctx.dim = dim
        ctx.sizes = [s.shape[dim] for s in shards]
        ctx.src = [s.device for s in shards]
        return tuple(torch.cat([s.to(d) for s in shards], dim)
                     for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        out, off = [], 0
        for n, dev in zip(ctx.sizes, ctx.src):
            parts = [g.narrow(ctx.dim, off, n) for g in grads if g is not None]
            out.append(_fixed_sum(parts, dev) if parts else None)
            off += n
        return (None, None, *out)


class _AllReduce(torch.autograd.Function):
    """The members' partials of one model group → their sum on each
    member, added in member order (once per distinct device).  Backward:
    the same sum of the outputs' gradients."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.set_materialize_grads(False)
        ctx.devs = [p.device for p in parts]
        return _per_device_sums(list(parts), ctx.devs)

    @staticmethod
    def backward(ctx, *grads):
        got = [g for g in grads if g is not None]
        if not got:
            return (None,) * len(ctx.devs)
        return _per_device_sums(got, ctx.devs)


def _per_device_sums(parts: list, devs: list) -> tuple:
    sums: dict = {}
    out = []
    for d in devs:
        if d in sums:
            out.append(sums[d].clone())
        else:
            sums[d] = _fixed_sum(parts, d)
            out.append(sums[d])
    return tuple(out)


def _per_device_max(parts: list, devs: list) -> list:
    """The elementwise maximum of ``parts`` on each of ``devs``."""
    got: dict = {}
    for d in devs:
        if d not in got:
            m = parts[0].to(d)
            for p in parts[1:]:
                m = torch.maximum(m, p.to(d))
            got[d] = m
    return [got[d] for d in devs]


class LMMesh:
    """Runs ``lm`` (an ``LM`` of any family with a mesh) over its mesh:
    the ``loss`` / ``prefill`` / ``decode_step`` of the ``LM`` API, plus
    :meth:`logits` (every position's logits, gathered) and the MoE
    pieces (:meth:`route`, :meth:`moe`) for tests."""

    def __init__(self, lm):
        mesh = lm.mesh
        tpn = mesh.shape.get("model", 1)
        if lm.tp != tpn:
            raise ValueError(f"LM(tp={lm.tp}) on a mesh whose model axis has "
                             f"{tpn} members: pass tp={tpn}")
        # the LM owns its executor (``lm._spmd``): a weak reference back
        # leaves no cycle, so a dropped LM frees its shards at once
        self.lm, self.mesh = weakref.proxy(lm), mesh
        self.units = units(lm)
        self.n = mesh.size
        self.devs = mesh.devices
        co = [mesh.coords(k) for k in range(self.n)]
        groups: dict = {}
        for k in range(self.n):
            key = tuple(v for a, v in co[k].items() if a != "model")
            groups.setdefault(key, []).append(k)
        self.model_groups = list(groups.values())
        self.model_idx = [co[k].get("model", 0) for k in range(self.n)]
        self._views: dict = {}
        self._plans: dict = {}
        self._slices: dict = {}
        emb = lm.params["embed"]
        self.vocab_split = "model" in _names(emb.sharding.spec[0])
        head = emb if lm.cfg.tie_embeddings else lm.params["lm_head"]
        vdim = 0 if lm.cfg.tie_embeddings else 1
        self.embed_off = [emb.sharding.member_index(k, emb.shape)[0].start
                          for k in range(self.n)]
        self.head_off = [head.sharding.member_index(k, head.shape)[vdim].start
                         for k in range(self.n)]

    # ------------------------------------------------------------ weights
    def _leaf(self, path: tuple, tree=None) -> ShardedTensor:
        return _get(self.lm.params if tree is None else tree, path)

    def _view(self, path: tuple, k: int, idx: tuple):
        """Member ``k``'s shard of leaf ``path`` at stacking index ``idx``:
        with ``trainable``, a parameter whose ``.grad`` views the
        member's gradient shard (built once)."""
        key = (path, k, idx)
        v = self._views.get(key)
        if v is None:
            v = self._leaf(path).shards[k][idx]
            if self.lm.trainable:
                v = nn.Parameter(v, requires_grad=True)
                v.grad = self._leaf(path, self.lm.grads).shards[k][idx]
            self._views[key] = v
        return v

    def _plan(self, path: tuple):
        """``None`` for a leaf split over ``model`` alone, else ``(dim,
        groups)``: the dimension split over other axes and the gather
        groups (members equal outside those axes, in block order)."""
        if path not in self._plans:
            st = self._leaf(path)
            sh = st.sharding
            gdims = [i for i, e in enumerate(sh.spec)
                     if any(n != "model" for n in _names(e))]
            plan = None
            if gdims:
                if len(gdims) > 1 or "model" in _names(sh.spec[gdims[0]]):
                    raise NotImplementedError(
                        f"{'/'.join(path)} {sh.spec}: the mesh executor "
                        f"gathers one dimension split over axes other than "
                        f"model")
                plan = (gdims[0],
                        self._dim_groups(sh, st.shape, gdims[0])[1])
            self._plans[path] = plan
        return self._plans[path]

    def local(self, path: tuple, idx: tuple = ()) -> list:
        """Per member: leaf ``path`` at ``idx`` with every axis but
        ``model`` gathered (the member's model-axis slice, whole)."""
        views = [self._view(path, k, idx) for k in range(self.n)]
        plan = self._plan(path)
        if plan is None:
            return views
        return self.allgather(views, plan[1], plan[0] - len(idx))

    def _tree(self, u: Unit, *sub) -> list:
        """Per member: the unit's subtree ``sub`` (``"attn"``, ``"mlp"``,
        ``"moe"``) as a dict of :meth:`local` tensors."""
        out = [{} for _ in range(self.n)]
        for name, v in self._leaf(u.prefix + sub).items():
            got = self._tree(u, *sub, name) if isinstance(v, dict) else \
                self.local(u.prefix + sub + (name,), u.idx)
            for k in range(self.n):
                out[k][name] = got[k]
        return out

    def _member_slice(self, path: tuple, dim: int) -> list:
        """Per member: its slice of dimension ``dim`` of leaf ``path``
        (``None`` where the member holds it whole)."""
        key = (path, dim)
        if key not in self._slices:
            st = self._leaf(path)
            whole = st.sharding.shard_shape(st.shape)[dim] == st.shape[dim]
            self._slices[key] = [
                None if whole else st.sharding.member_index(k, st.shape)[dim]
                for k in range(self.n)]
        return self._slices[key]

    def heads(self, u: Unit, sub: str = "attn") -> list:
        """Per member: the query heads it computes in unit ``u``'s
        attention ``sub`` (``"xattn"``: the cross-attention; a slice of
        the padded ``hq``; ``None``: all of them)."""
        q = "w_uq" if isinstance(u.attn, MLACfg) else "wq"
        return self._member_slice(u.prefix + (sub, q), len(u.idx) + 1)

    def full(self, path: tuple, idx: tuple = ()) -> list:
        """Per member: leaf ``path`` at ``idx`` whole (every split axis
        gathered, ``model`` too): the mamba block's per-channel leaves."""
        views = [self._view(path, k, idx) for k in range(self.n)]
        st = self._leaf(path)
        dims = [i for i, e in enumerate(st.sharding.spec) if _names(e)]
        if not dims:
            return views
        if len(dims) > 1:
            raise NotImplementedError(
                f"{'/'.join(path)} {st.sharding.spec}: the mesh executor "
                f"gathers one split dimension")
        _, groups = self._dim_groups(st.sharding, st.shape, dims[0])
        return self.allgather(views, groups, dims[0] - len(idx))

    def allgather(self, parts: list, groups: list, dim: int) -> list:
        """Per member: its group's ``parts`` concatenated along ``dim`` in
        group order (``.to()`` copies)."""
        out = [None] * self.n
        for g in groups:
            if len(g) == 1:
                out[g[0]] = parts[g[0]]
                continue
            res = _Gather.apply(dim, tuple(self.devs[k] for k in g),
                                *[parts[k] for k in g])
            for k, r in zip(g, res):
                out[k] = r
        return out

    def gsum(self, parts: list, groups: list) -> list:
        """Per member: the sum of its group's ``parts``, in group order."""
        out = [None] * self.n
        for g in groups:
            if len(g) == 1:
                out[g[0]] = parts[g[0]]
                continue
            for k, r in zip(g, _AllReduce.apply(*[parts[k] for k in g])):
                out[k] = r
        return out

    def psum(self, parts: list) -> list:
        """Per member: the sum of its model group's ``parts``."""
        return self.gsum(parts, self.model_groups)

    @torch.no_grad()
    def pmax(self, parts: list) -> list:
        """Per member: the elementwise max over its model group."""
        out = [None] * self.n
        for g in self.model_groups:
            got = _per_device_max([parts[j] for j in g],
                                  [self.devs[k] for k in g])
            for k, m in zip(g, got):
                out[k] = m
        return out

    # --------------------------------------------------------------- rows
    def _rows(self, batch: int) -> list:
        """Per member: its rows of a global batch of ``batch``."""
        bspec = batch_axes(self.lm.rules, batch, self.mesh)
        if bspec is None:
            return [slice(None)] * self.n
        sh = NamedSharding(self.mesh, PartitionSpec(bspec))
        return [sh.member_index(k, (batch,))[0] for k in range(self.n)]

    def _split(self, t: torch.Tensor, rows: list, dtype=None) -> list:
        return [t[rows[k]].to(self.devs[k], dtype) for k in range(self.n)]

    def _leaders(self, rows: list) -> list:
        """One member (model index 0) per distinct row range, in row
        order."""
        seen, out = set(), []
        for k in range(self.n):
            key = (rows[k].start, rows[k].stop)
            if self.model_idx[k] == 0 and key not in seen:
                seen.add(key)
                out.append(k)
        return sorted(out, key=lambda k: rows[k].start or 0)

    def _join(self, per_member: list, rows: list) -> torch.Tensor:
        """Per-member row results → the global batch on ``lm.device``."""
        dev = self.lm.device
        return torch.cat([per_member[k].to(dev)
                          for k in self._leaders(rows)])

    # -------------------------------------------------------------- model
    def _embed(self, toks: list) -> list:
        table = self.local(("embed",))
        dt = self.lm.dtype
        parts = []
        for k in range(self.n):
            t, tab = toks[k].long(), table[k]
            if not self.vocab_split:
                parts.append(tab[t].to(dt))
                continue
            off, vm = self.embed_off[k], tab.shape[0]
            hit = (t >= off) & (t < off + vm)
            rows = tab[(t - off).clamp(0, vm - 1)].to(dt)
            parts.append(torch.where(hit[..., None], rows,
                                     torch.zeros((), dtype=dt,
                                                 device=rows.device)))
        return self.psum(parts) if self.vocab_split else parts

    def _normed(self, u: Unit, ln: str, xs: list) -> list:
        w = self.local(u.prefix + (ln,), u.idx)
        eps = self.lm.cfg.norm_eps
        return [rms_norm(x, w[k], eps) for k, x in enumerate(xs)]

    def _ffn(self, u: Unit, xs: list, rows: list) -> list:
        """``x + ffn(ln2(x))``: the SwiGLU MLP's partial sums, or the
        routed and shared experts."""
        hs = self._normed(u, "ln3" if u.kind == "dec" else "ln2", xs)
        if u.ffn == "mlp":
            w = self._tree(u, "mlp")
            ys = self.psum([mlp_apply(w[k], hs[k]) for k in range(self.n)])
        else:
            ys = self.moe(u, hs, rows)
        return [x + y for x, y in zip(xs, ys)]

    def _unit(self, u: Unit, xs: list, rows: list, ctx: dict):
        """Unit ``u`` over the whole sequence → (xs', per member its cache
        outputs: (k, v), MLA's (c_kv, k_pe), a mamba layer's (conv state,
        SSM state) slices, a decoder layer's ((k, v), cross (k, v))).
        ``ctx``: the global batch ``b`` and the encoder's output
        ``enc``."""
        if u.kind == "mamba":
            return self._mamba(u, xs, ctx["b"])
        hs = self._normed(u, "ln1", xs)
        p = self._tree(u, "attn")
        heads = self.heads(u)
        parts, kvs = [], []
        for k in range(self.n):
            if isinstance(u.attn, MLACfg):
                y, kv = mla_apply(u.attn, p[k], hs[k], heads=heads[k])
            else:
                y, kv = attn_apply(u.attn, p[k], hs[k], heads=heads[k],
                                   kind="bidir" if u.kind == "enc"
                                   else "causal")
            parts.append(y)
            kvs.append(kv)
        xs = [x + s for x, s in zip(xs, self.psum(parts))]
        if u.kind == "dec":
            xs, xkvs = self._cross(u, xs, ctx["enc"])
            kvs = list(zip(kvs, xkvs))
        return self._ffn(u, xs, rows), kvs

    def _cross(self, u: Unit, xs: list, enc: list):
        """A decoder layer's cross-attention half over the encoder's
        output (per member its rows, whole): each member its query heads
        and their keys and values → (xs', per member its cross (k, v))."""
        hs = self._normed(u, "ln2", xs)
        p = self._tree(u, "xattn")
        heads = self.heads(u, "xattn")
        kvs = [(_proj(enc[k], p[k]["wk"]), _proj(enc[k], p[k]["wv"]))
               for k in range(self.n)]
        parts = [_cross_attend(u.attn, p[k], hs[k], *kvs[k], heads[k])
                 for k in range(self.n)]
        return [x + s for x, s in zip(xs, self.psum(parts))], kvs

    def _cross_step(self, u: Unit, xs: list, work: dict) -> list:
        """A decoder layer's cross-attention half for one token, over the
        cache's ``xk`` / ``xv`` under their spec (read, never written:
        R6)."""
        hs = self._normed(u, "ln2", xs)
        p = self._tree(u, "xattn")
        heads = self.heads(u, "xattn")
        xk, xv = work[u.site + ("xk",)], work[u.site + ("xv",)]
        span, groups = self._dim_groups(xk.sharding, xk.shape,
                                        len(u.cidx) + 1)
        if not all(len(g) == 1 for g in groups):
            parts = self._seq_parallel(u, p, hs, xk, xv, 0, heads, span,
                                       groups, cross=True)
        else:
            parts = [_cross_attend(u.attn, p[k], hs[k], xk.shards[k][u.cidx],
                                   xv.shards[k][u.cidx], heads[k])
                     for k in range(self.n)]
        return [x + s for x, s in zip(xs, self.psum(parts))]

    # ------------------------------------------------------- mamba layers
    def _mamba_layout(self, b: int):
        """The working layout of the mamba states at a batch of ``b``
        (``cache_sharding`` with the batch at its true position) → (per
        member its slice of the SSM state's ``P``, ``None`` where whole;
        the ``P`` groups; per member its slice of the conv state's
        channels, ``None`` where whole; the channel groups)."""
        key = ("mamba", b)
        if key not in self._slices:
            like = self.lm._zero_cache(b, 1, None, "meta")
            got = []
            for name, off in (("ssm", 2), ("conv", 1)):
                shape = like[name].shape
                bdim = len(shape) - (4 if name == "ssm" else 3)
                sh = self.lm.cache_sharding(shape, b, bdim=bdim)
                if any(_names(e) for i, e in enumerate(sh.spec)
                       if i not in (bdim, bdim + off)):
                    raise NotImplementedError(
                        f"the {name} state's working spec {sh.spec}: the "
                        f"mesh executor splits its batch and dimension "
                        f"{bdim + off} only")
                span, groups = self._dim_groups(sh, shape, bdim + off)
                whole = span[0].stop - span[0].start == shape[bdim + off]
                got += [[None if whole else sp for sp in span], groups]
            self._slices[key] = tuple(got)
        return self._slices[key]

    def _mamba(self, u: Unit, xs: list, b: int, work: dict | None = None):
        """A mamba layer ``x + mamba(ln(x))`` over the whole sequence, or
        with ``work`` one decode step (its states read and written in
        ``work``'s shards) → (xs', per member its [conv state, SSM state]
        slices in the working layout; ``None`` for a decode step).

        Each member computes its column block of ``in_proj``'s product;
        the model group's blocks are gathered, so each member holds the
        whole z | xBC | dt of its rows.  The per-channel leaves are
        gathered whole.  Each member runs the conv on the channels its
        ``P`` slice reads (decode: on its block of the conv state, the
        outputs gathered over the block's group), the SSD scan or the
        recurrence on its ``P`` slice of every head, and the gate; the
        norm's sum of squares is summed over the ``P`` group in member
        order; each member then takes the channels of its ``out_proj``
        rows from its ``P`` group (its heads, every ``P`` slice), and the
        row blocks' partial products are summed over ``model``."""
        c = u.attn
        path = u.prefix + ("mamba",)
        ps, pgroups, cs, cgroups = self._mamba_layout(b)
        hs = self._normed(u, "ln", xs)
        w_in = self.local(path + ("in_proj",), u.idx)
        st = self._leaf(path + ("in_proj",))
        _, cols = self._dim_groups(st.sharding, st.shape, len(u.idx) + 1)
        zx = self.allgather([in_project({"in_proj": w_in[k]}, h)
                             for k, h in enumerate(hs)], cols, -1)
        small = {n: self.full(path + (n,), u.idx) for n in
                 ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
                  "norm_w")}
        per = [{n: v[k] for n, v in small.items()} for k in range(self.n)]
        conv_out, states = [], [None] * self.n
        for k in range(self.n):
            _, xbc, _ = _split_proj(c, zx[k])
            w = per[k]
            if work is not None:      # the window step on its block
                blk = cs[k] or slice(None)
                cst = work[u.site + ("conv",)].shards[k][u.cidx]
                out, nxt = conv_step(c, {"conv_w": w["conv_w"][blk],
                                         "conv_b": w["conv_b"][blk]},
                                     cst, xbc[:, 0, blk])
                cst.copy_(nxt)
                conv_out.append(out[:, None])
            else:
                conv_out.append(_causal_conv(
                    c, {"conv_w": p_channels(c, w["conv_w"].T, ps[k]).T,
                        "conv_b": p_channels(c, w["conv_b"], ps[k])},
                    p_channels(c, xbc, ps[k])))
                tail = zx[k][:, -(c.conv_kernel - 1):,
                             c.d_inner:c.d_inner + c.conv_dim]
                states[k] = [tail.transpose(1, 2)[:, cs[k] or slice(None)]]
        if work is not None:
            conv_out = [p_channels(c, o, ps[k]) for k, o in
                        enumerate(self.allgather(conv_out, cgroups, -1))]
        gs, sq = [], []
        for k in range(self.n):
            z, _, dt_raw = _split_proj(c, zx[k])
            n = c.d_state
            x, b_in, c_in = torch.split(
                conv_out[k], [conv_out[k].shape[-1] - 2 * n, n, n], -1)
            bsz, s = x.shape[:2]
            x = x.reshape(bsz, s, c.n_heads, -1)
            if work is not None:
                sst = work[u.site + ("ssm",)].shards[k][u.cidx]
                y, nxt = ssd_step(c, per[k], x[:, 0], dt_raw[:, 0],
                                  b_in[:, 0], c_in[:, 0], sst)
                sst.copy_(nxt)
                y = y[:, None]
            else:
                y, h_final = ssd_scan(c, per[k], x, dt_raw, b_in, c_in)
                states[k].append(h_final)
            y = y.reshape(bsz, s, -1).to(zx[k].dtype)
            g = gate(y, p_channels(c, z, ps[k], inner=True))
            gs.append(g)
            sq.append(None if ps[k] is None else norm_sumsq(g))
        if ps[0] is not None:
            sq = self.gsum(sq, pgroups)
        ys = [gated_norm(c, g, p_channels(c, per[k]["norm_w"], ps[k],
                                          inner=True), sq[k])
              for k, g in enumerate(gs)]
        opath = path + ("out_proj",)
        orows = self._member_slice(opath, len(u.idx))
        w_out = self.local(opath, u.idx)
        group_of = {k: g for g in pgroups for k in g}
        parts = []
        for k in range(self.n):
            r = orows[k] or slice(0, c.d_inner)
            if ps[k] is None:
                yk = ys[k][..., r]
            else:         # its rows' heads, every P slice, in P order
                hd = c.head_dim
                h0, h1 = r.start // hd, -(-r.stop // hd)
                yk = torch.cat([ys[j].unflatten(-1, (c.n_heads, -1))
                                [..., h0:h1, :].to(self.devs[k])
                                for j in group_of[k]], -1).flatten(-2)
                yk = yk[..., r.start - h0 * hd:r.stop - h0 * hd]
            parts.append(out_project({"out_proj": w_out[k]}, yk))
        if orows[0] is not None:
            parts = self.psum(parts)
        return [x + y for x, y in zip(xs, parts)], \
            (None if work is not None else states)

    def _hidden(self, batch: dict, emit_cache: bool = False):
        """→ (per-member final-normed hidden states, rows, per unit ``(u,
        its per-member cache outputs)``, or None)."""
        lm, c = self.lm, self.lm.cfg
        tokens = torch.as_tensor(batch["tokens"])
        b = tokens.shape[0]
        rows = self._rows(b)
        ctx = {"b": b}
        remat = lm.remat and lm.trainable and torch.is_grad_enabled()
        if c.family == "encdec":
            enc = self._split(torch.as_tensor(batch["frames"]), rows,
                              lm.dtype)
            for u in self.units:
                if u.kind == "enc":
                    enc, _ = self._run(u, enc, rows, ctx, remat)
            norm = self.local(("enc_norm",))
            ctx["enc"] = [rms_norm(e, norm[k], c.norm_eps)
                          for k, e in enumerate(enc)]
        xs = self._embed(self._split(tokens, rows))
        if c.prefix_len:
            pre = self._split(torch.as_tensor(batch["prefix"]), rows,
                              lm.dtype)
            xs = [torch.cat([p, x], dim=1) for p, x in zip(pre, xs)]
        outs = []
        for u in self.units:
            if u.kind == "enc":
                continue
            xs, kvs = self._run(u, xs, rows, ctx, remat)
            if emit_cache:
                outs.append((u, kvs))
        norm = self.local(("final_norm",))
        xs = [rms_norm(x, norm[k], c.norm_eps) for k, x in enumerate(xs)]
        return xs, rows, (outs if emit_cache else None)

    def _run(self, u: Unit, xs: list, rows: list, ctx: dict, remat: bool):
        """:meth:`_unit`, or with ``remat`` the unit under a checkpoint
        (a unit with ``u.remat``: those the JAX package's ``_maybe_remat``
        wraps) → (xs', its cache outputs, or
        ``None`` under the checkpoint).

        The checkpoint is reentrant: the backward re-runs the unit and
        backprops through the new graph (the non-reentrant form matches
        saved tensors by order, which a mesh of several devices, one
        autograd thread each, was seen to break).  So every tensor the
        unit reads that carries a graph is an input, never a closure (a
        decoder layer's encoder output: a closure's graph would be
        walked again by each layer's inner backward), and a leaf that
        requires a gradient rides along, so the encoder's first layer,
        over frames that need none, still records its parameters'
        gradients."""
        if not (remat and u.remat):
            return self._unit(u, xs, rows, ctx)
        n = len(xs)
        enc = list(ctx["enc"]) if u.kind == "dec" else []

        def body(*args):
            got = dict(ctx, enc=list(args[n:n + len(enc)])) if enc else ctx
            return tuple(self._unit(u, list(args[:n]), rows, got)[0])
        anchor = torch.empty(0, requires_grad=True)
        return list(checkpoint(body, *xs, *enc, anchor,
                               use_reentrant=True)), None

    # ------------------------------------------------------ routed experts
    def route(self, u: Unit, hs: list, rows: list):
        """The unit's routing, once, on the first member: the token rows
        (B·S, d) gathered there in batch order, then ``moe_route`` →
        (Routing, the gathered rows)."""
        lead = self._leaders(rows)
        d = hs[0].shape[-1]
        dev = self.devs[lead[0]]
        xt = torch.cat([hs[j].reshape(-1, d).to(dev) for j in lead])
        router = self.local(u.prefix + ("moe", "router"), u.idx)[lead[0]]
        return moe_route(self.lm.moe_cfg, router, xt), xt

    def moe(self, u: Unit, hs: list, rows: list) -> list:
        """Per member: the MoE half's output (the routed experts, plus
        the shared ones) for its rows of ``hs`` (the normed inputs,
        (B_k, S, d) a member)."""
        c = self.lm.moe_cfg
        kt, dt = c.top_k, hs[0].dtype
        b_k, s, d = hs[0].shape
        w = self._tree(u, "moe")
        r, xt = self.route(u, hs, rows)
        n_tok = xt.shape[0]
        counts = torch.bincount(r.sorted_e, minlength=c.n_experts)
        starts = torch.cumsum(counts, 0) - counts
        src = r.order // kt
        w_slots = r.top_w.reshape(-1)[r.order]
        pos = combine_order(r)
        # the routing, copied once to each device
        routing: dict = {}
        for dev in dict.fromkeys(self.devs):
            routing[dev] = [t.to(dev) for t in (counts, starts, src,
                                                r.sorted_e, r.slot, r.keep,
                                                w_slots, pos)]
        blocks = self._member_slice(u.prefix + ("moe", "w1"), len(u.idx))
        lead = self._leaders(rows)
        flat = {j: hs[j].reshape(-1, d) for j in lead}
        span = {}
        for j in lead:
            lo = (rows[j].start or 0) * s
            span[j] = (lo, lo + flat[j].shape[0])
        out_buf = []
        for k in range(self.n):
            dev = self.devs[k]
            cnt, st, src_k = routing[dev][:3]
            blk = blocks[k] or slice(0, c.n_experts)
            slots = torch.arange(r.cap, device=dev)
            # the bucket entries of this member's experts: sorted entry
            # starts[e] + slot for slot < min(count, cap)
            ent = (st[blk, None] + slots).clamp(max=n_tok * kt - 1)
            tok = src_k[ent]
            valid = slots < cnt[blk, None]
            buf = torch.zeros((*tok.shape, d), dtype=dt, device=dev)
            for j in lead:                      # the rows' owners
                lo, hi = span[j]
                dj = self.devs[j]
                mine = (valid & (tok >= lo) & (tok < hi)).to(dj)
                got = flat[j][(tok.to(dj) - lo).clamp(0, hi - lo - 1)]
                buf = buf + torch.where(mine[..., None], got,
                                        torch.zeros((), dtype=dt,
                                                    device=dj)).to(dev)
            out_buf.append(expert_ffn(w[k], buf))
        routed = [None] * self.n
        for g in self.model_groups:
            lo = (rows[g[0]].start or 0) * s
            hi = lo + b_k * s
            acc = None
            for m in g:
                dev = self.devs[m]
                _, _, _, se, sl, keep, ws, ps = routing[dev]
                ps = ps[lo:hi]
                e = se[ps]
                blk = blocks[m] or slice(0, c.n_experts)
                hit = keep[ps] & (e >= blk.start) & (e < blk.stop)
                ob = out_buf[m]
                val = ob[(e - blk.start).clamp(0, ob.shape[0] - 1),
                         sl[ps].clamp(0, r.cap - 1)] * ws[ps][..., None].to(dt)
                val = torch.where(hit[..., None], val,
                                  torch.zeros((), dtype=dt, device=dev))
                acc = torch.zeros((hi - lo, d), dtype=dt, device=dev) \
                    if acc is None else acc.to(dev)
                # each token's entries in ascending expert id, continuing
                # the sum the previous member's block left
                for j in range(kt):
                    acc = acc + val[:, j]
            for m in g:
                routed[m] = acc.to(self.devs[m])
        if c.n_shared:
            sh = self.psum([mlp_apply(w[k]["shared"], hs[k].reshape(-1, d))
                            for k in range(self.n)])
            routed = [y + z for y, z in zip(routed, sh)]
        return [y.reshape(b_k, s, d) for y in routed]

    # ------------------------------------------------------------- logits
    def _logits(self, xs: list) -> list:
        """Per member: float32 logits over its vocabulary columns, the
        padded columns ``-1e30``."""
        c = self.lm.cfg
        if c.tie_embeddings:
            head = [t.T for t in self.local(("embed",))]
        else:
            head = self.local(("lm_head",))
        out = []
        for k, x in enumerate(xs):
            lg = (x @ head[k].to(x.dtype)).float()
            cut = c.vocab_size - self.head_off[k]
            if cut < lg.shape[-1]:
                lg[..., max(cut, 0):] = -1e30
            out.append(lg)
        return out

    def _pick(self, lgs: list) -> list:
        """Per member: the global tournament argmax of the last axis
        (int32), over its model group's columns."""
        loc = [argmax_tournament(lg) for lg in lgs]
        val = [lg.gather(-1, i.long()[..., None])[..., 0]
               for lg, i in zip(lgs, loc)]
        out = [None] * self.n
        for g in self.model_groups:
            for k in g:
                dev = self.devs[k]
                vals = torch.stack([val[j].to(dev) for j in g], dim=-1)
                idx = torch.stack([(loc[j] + self.head_off[j]).to(dev)
                                   for j in g], dim=-1)
                win = argmax_tournament(vals)
                out[k] = idx.gather(-1, win.long()[..., None])[..., 0]
        return out

    # ----------------------------------------------------- decode caches
    def _prefill_cache(self, outs: list, b: int):
        """Per unit its per-member cache outputs → the JAX prefill cache
        tree (dense ``(k, v)``; llama4 ``((k, v) local, (k, v) global)``;
        deepseek ``((c_kv, k_pe) first, (c_kv, k_pe) rest)``; ssm ``(conv,
        ssm)``; hybrid ``((conv, ssm), (k, v))``; encdec ``((k, v), (xk,
        xv))``), each leaf a ShardedTensor: batch over the data axes
        where it divides, KV heads over ``model`` where the spec splits
        them; the mamba states in their working layout."""
        lm = self.lm
        bspec = batch_axes(lm.rules, b, self.mesh)
        sites: dict = {}
        for u, per in outs:
            if u.kind == "dec":       # the self- and the cross-attention
                sites.setdefault((u.site, "self"), []).append(
                    (u, [p[0] for p in per]))
                sites.setdefault((u.site, "cross"), []).append(
                    (u, [p[1] for p in per]))
            else:
                sites.setdefault((u.site, u.kind), []).append((u, per))
        tree = []
        for items in sites.values():
            u0 = items[0][0]
            lead = tuple(max(u.cidx[d] for u, _ in items) + 1
                         for d in range(len(u0.cidx)))
            pair = []
            for j in range(2):
                shards = []
                for k in range(self.n):
                    ts = [kv[k][j] for _, kv in items]
                    shards.append(torch.stack(ts).reshape(*lead, *ts[0].shape)
                                  if lead else ts[0])
                shape = list(shards[0].shape)
                shape[len(lead)] = b
                if u0.kind == "mamba":
                    # (.., B, conv_dim, K−1) and (.., B, H, P, N)
                    shape[len(lead) + 1 + j] = (u0.attn.conv_dim,
                                                u0.attn.head_dim)[j]
                    sh = lm.cache_sharding(shape, b, bdim=len(lead))
                else:
                    spec = [None] * len(shape)
                    spec[len(lead)] = bspec
                    if not isinstance(u0.attn, MLACfg):
                        shape[len(lead) + 2] = u0.attn.hkv
                        if lm.rules["kv_heads"] == "model":
                            spec[len(lead) + 2] = "model"
                    sh = NamedSharding(self.mesh, PartitionSpec(*spec))
                want = sh.shard_shape(shape)
                if any(tuple(t.shape) != want for t in shards):
                    raise AssertionError(f"prefill cache shards "
                                         f"{[tuple(t.shape) for t in shards]}"
                                         f" against {want} under {sh.spec}")
                pair.append(ShardedTensor(sh, shape, shards))
            tree.append(tuple(pair))
        return tree[0] if len(tree) == 1 else tuple(tree)

    def _working(self, cache: dict, b: int) -> dict:
        """Each cache leaf the units read, in the layout the executor
        computes in (``cache_sharding`` with the batch at its true
        position): the stored leaf itself where its spec is that one,
        else a regathered copy (written back by :meth:`_write_back`)."""
        work = {}
        for u in self.units:
            for name in _cache_names(u):
                path = u.site + (name,)
                if path in work:
                    continue
                st = _get(cache, path)
                want = self.lm.cache_sharding(st.shape, b, bdim=len(u.cidx))
                if tuple(want.spec) == tuple(st.sharding.spec):
                    work[path] = st
                else:
                    work[path] = ShardedTensor.from_full(
                        st.gather(self.lm.device), want)
        return work

    def _write_back(self, cache: dict, work: dict) -> None:
        for path, w in work.items():
            st = _get(cache, path)
            if w is not st and path[-1] not in READ_ONLY:
                st.copy_(w.gather(self.lm.device))

    def _dim_groups(self, sh: NamedSharding, shape, dim: int):
        """→ (per member its slice of dimension ``dim`` of an array of
        ``shape`` under ``sh``, the groups: members equal outside the
        axes that split it, in slice order; singletons where nothing
        splits it)."""
        axes = _names(sh.spec[dim]) if dim < len(sh.spec) else ()
        span = [sh.member_index(k, shape)[dim] for k in range(self.n)]
        if not axes:
            return span, [[k] for k in range(self.n)]
        groups: dict = {}
        for k in range(self.n):
            co = self.mesh.coords(k)
            key = tuple(v for a, v in co.items() if a not in axes)
            groups.setdefault(key, []).append(k)
        return span, [sorted(g, key=lambda k: span[k].start)
                      for g in groups.values()]

    def _attn_step(self, u: Unit, xs: list, work: dict, pos: int) -> list:
        """Unit ``u``'s attention half for one token, its cache entry
        written at ``pos``."""
        hs = self._normed(u, "ln1", xs)
        p = self._tree(u, "attn")
        heads = self.heads(u)
        na, nb = _cache_names(u)[:2]
        ca, cb = work[u.site + (na,)], work[u.site + (nb,)]
        span, groups = self._dim_groups(ca.sharding, ca.shape,
                                        len(u.cidx) + 1)
        if all(len(g) == 1 for g in groups):
            fn = mla_decode if isinstance(u.attn, MLACfg) else attn_decode
            parts = [fn(u.attn, p[k], hs[k], ca.shards[k][u.cidx],
                        cb.shards[k][u.cidx], pos, heads=heads[k])[0]
                     for k in range(self.n)]
        else:
            parts = self._seq_parallel(u, p, hs, ca, cb, pos, heads, span,
                                       groups)
        return [x + s for x, s in zip(xs, self.psum(parts))]

    def _seq_parallel(self, u: Unit, p: list, hs: list, ca, cb, pos: int,
                      heads: list, span: list, groups: list,
                      cross: bool = False) -> list:
        """The decode attention over a length-sharded cache → per-member
        partial output projections (module docstring).  ``cross``: a
        decoder layer's cross-attention over ``xk`` / ``xv`` (queries
        without RoPE, every slot valid, nothing written, no head
        mask)."""
        c = u.attn
        mla = isinstance(c, MLACfg)
        s_cache = ca.shape[len(u.cidx) + 1]
        hsl = [h or slice(0, c.hq) for h in heads]
        qs = []
        for k in range(self.n):
            dev, dt = self.devs[k], hs[k].dtype
            at = torch.full((1,), pos, device=dev)
            if mla:
                q = _queries(c, p[k], hs[k], at)
                new_a, new_b = _latents(c, p[k], hs[k], at)
                write = min(max(pos, 0), s_cache - 1)
                q_nope, q_pe = q.split([c.nope_head_dim, c.rope_head_dim], -1)
                q_abs = torch.einsum("bqhd,lhd->bqhl", q_nope,
                                     p[k]["w_uk"].to(dt))
                qs.append(torch.cat([q_abs, q_pe], -1))
            elif cross:
                qs.append(_proj(hs[k], p[k]["wq"]))
                continue
            else:
                q, new_a, new_b = _project_qkv(c, p[k], hs[k], at)
                write = decode_slot(c, s_cache, pos)
                qs.append(q)
            lo, hi = span[k].start, span[k].stop
            if lo <= write < hi:           # only the slot's holder writes
                ca.shards[k][u.cidx][:, write - lo] = new_a[:, 0]
                cb.shards[k][u.cidx][:, write - lo] = new_b[:, 0]
        parts = [None] * self.n
        for g in groups:
            # the query heads the group scores: its members' heads, joined
            own = dict.fromkeys((hsl[k].start, hsl[k].stop) for k in g)
            by = sorted(own)
            h0, h1 = by[0][0], by[-1][1]
            src = {hr: next(k for k in g if (hsl[k].start, hsl[k].stop) == hr)
                   for hr in by}
            scores, vals = {}, {}
            for k in g:
                dev, dt = self.devs[k], hs[k].dtype
                q = qs[k] if len(by) == 1 else \
                    torch.cat([qs[src[hr]].to(dev) for hr in by], dim=2)
                a, b = ca.shards[k][u.cidx], cb.shards[k][u.cidx]
                idx = torch.arange(span[k].start, span[k].stop, device=dev)
                if mla:
                    q_abs, q_pe = q.split([c.kv_lora, c.rope_head_dim], -1)
                    ckv = a.to(dt)
                    sc = (torch.einsum("bqhl,bkl->bhqk", q_abs, ckv)
                          + torch.einsum("bqhd,bkd->bhqk", q_pe, b.to(dt))) \
                        / (c.qk_dim ** 0.5)
                    sc = torch.where(idx <= pos, sc.float(), -1e30)
                    vals[k] = ckv
                else:
                    ke, ve = expand_kv(a, c.rep), expand_kv(b, c.rep)
                    if ke.shape[2] != h1 - h0:    # every KV head held
                        ke, ve = ke[:, :, h0:h1], ve[:, :, h0:h1]
                    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                      ke.float()) / (c.head_dim ** 0.5)
                    if not cross:
                        sc = torch.where(decode_valid(c, s_cache, pos, idx),
                                         sc, -1e30)
                    vals[k] = ve
                scores[k] = sc
            devs = [self.devs[k] for k in g]
            mx = _per_device_max([scores[k].amax(-1, keepdim=True)
                                  for k in g], devs)
            ex = [torch.exp(scores[k] - m) for k, m in zip(g, mx)]
            se = _per_device_sums([e.sum(-1, keepdim=True) for e in ex], devs)
            pv = []
            for k, e, z in zip(g, ex, se):
                w = (e / z).to(hs[k].dtype)
                pv.append(torch.einsum("bhqk,bkl->bqhl" if mla else
                                       "bhqk,bkhd->bqhd", w, vals[k]))
            for k, o in zip(g, _per_device_sums(pv, devs)):
                o = o[:, :, hsl[k].start - h0:hsl[k].stop - h0]
                if mla:
                    o = torch.einsum("bqhl,lhd->bqhd", o,
                                     p[k]["w_uv"].to(o.dtype))
                    o = _mla_mask_heads(c, o, heads[k])
                elif not cross:
                    o = _attn_mask_heads(c, o, heads[k])
                parts[k] = _out_proj(o, p[k]["wo"])
        return parts

    # ---------------------------------------------------------------- API
    @torch.no_grad()
    def logits(self, batch: dict) -> torch.Tensor:
        """Every position's float32 logits (B, S, padded vocab), gathered
        onto ``lm.device`` (vocabulary columns in model order)."""
        xs, rows, _ = self._hidden(batch)
        lgs = self._logits(xs)
        dev = self.lm.device
        per = [None] * self.n
        for g in self.model_groups:
            full = torch.cat([lgs[j].to(dev) for j in g], dim=-1) \
                if self.vocab_split else lgs[g[0]].to(dev)
            for k in g:
                per[k] = full
        return self._join(per, rows)

    @torch.no_grad()
    def prefill(self, batch: dict):
        """→ (next token (B,) int32, the prefill cache, each leaf a
        ShardedTensor in the unsharded ``LM.prefill``'s tree)."""
        xs, rows, outs = self._hidden(batch, emit_cache=True)
        tok = self._pick([lg[:, 0] for lg in
                          self._logits([x[:, -1:] for x in xs])])
        b = torch.as_tensor(batch["tokens"]).shape[0]
        return self._join(tok, rows), self._prefill_cache(outs, b)

    def loss(self, batch: dict):
        """→ (loss, {"loss", "acc"}), as ``LM.loss``."""
        c = self.lm.cfg
        xs, rows, _ = self._hidden(batch)
        if c.prefix_len:
            xs = [x[:, c.prefix_len:] for x in xs]
        lgs = self._logits(xs)
        tgts = self._split(torch.as_tensor(batch["targets"]), rows)
        m = self.pmax([lg.max(-1).values.detach() for lg in lgs])
        se, lt = [], []
        for k, lg in enumerate(lgs):
            se.append(torch.sum(torch.exp(lg - m[k][..., None]), dim=-1))
            off, vm = self.head_off[k], lg.shape[-1]
            t = tgts[k].long()
            hit = (t >= off) & (t < off + vm)
            got = lg.gather(-1, (t - off).clamp(0, vm - 1)[..., None])[..., 0]
            lt.append(torch.where(hit, got, torch.zeros_like(got)))
        if self.vocab_split:
            se, lt = self.psum(se), self.psum(lt)
        pick = self._pick(lgs)
        dev = self.lm.device
        lead = self._leaders(rows)
        n_tok = sum(tgts[k].numel() for k in lead)
        loss = _fixed_sum([(torch.log(se[k]) + m[k] - lt[k]).sum()
                           for k in lead], dev) / n_tok
        hits = _fixed_sum([(pick[k] == tgts[k]).sum() for k in lead], dev)
        acc = hits.float() / n_tok
        return loss, {"loss": loss.detach(), "acc": acc}

    @torch.no_grad()
    def decode_step(self, cache: dict, token: torch.Tensor, pos):
        """One token (B, 1) at ``pos`` → (next token (B,) int32, cache),
        the cache's shards written in place."""
        c = self.lm.cfg
        pos = int(pos)
        token = torch.as_tensor(token)
        b = token.shape[0]
        rows = self._rows(b)
        work = self._working(cache, b)
        xs = self._embed(self._split(token, rows))
        for u in self.units:
            if u.kind == "enc":
                continue
            if u.kind == "mamba":
                xs, _ = self._mamba(u, xs, b, work)
                continue
            xs = self._attn_step(u, xs, work, pos)
            if u.kind == "dec":
                xs = self._cross_step(u, xs, work)
            xs = self._ffn(u, xs, rows)
        self._write_back(cache, work)
        norm = self.local(("final_norm",))
        xs = [rms_norm(x, norm[k], c.norm_eps) for k, x in enumerate(xs)]
        tok = self._pick([lg[:, 0] for lg in self._logits(xs)])
        return self._join(tok, rows), cache

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """Sum the gradient copies of every replicated slice in member
        order into each copy."""
        for g in _leaves(self.lm.grads):
            groups: dict = {}
            for k in range(self.n):
                groups.setdefault(g.sharding.block(k), []).append(k)
            for members in groups.values():
                if len(members) < 2:
                    continue
                sums = _per_device_sums([g.shards[k] for k in members],
                                        [self.devs[k] for k in members])
                for k, s in zip(members, sums):
                    g.shards[k].copy_(s)
