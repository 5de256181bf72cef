"""The dense and moe families over a device mesh: what GSPMD does with
the LM's specs, written out for a single process (the port's counterpart
of ``jax.jit`` with ``param_shardings`` / ``input_shardings`` on a
``("data", "model")`` or ``("pod", "data", "model")`` mesh).

Every member of ``lm.mesh`` holds only its shards (``lm.params`` leaves
are :class:`~repro_torch.distributed.sharding.ShardedTensor`\\ s) and
computes on its own device; one thread launches each member's work in
turn, so a mesh that repeats one device runs its members one after
another (more launches and copies, no speedup).  The model is a list of
:class:`Unit`\\ s (an attention half and an FFN half each: a dense layer;
a llama4 chunked-local or global NoPE layer, in superblock order; a
deepseek MLA layer, the dense first one then the MoE ones).  Per unit:

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

Gradients (dense family): each member's view of a stacked leaf is a
parameter whose ``.grad`` views that member's shard of ``lm.grads``;
after the backward pass :meth:`LMMesh.reduce_grads` sums the copies of a
replicated slice in member order (norm weights, replicated KV
projections).  The moe family's ``loss`` is held in value; its gradients
are ROADMAP.md, queue 1, item 7g.
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
from .attention import (_out_proj, _project_qkv, attn_apply, attn_decode,
                        decode_slot, decode_valid)
from .common import expand_kv, rms_norm
from .mla import _mask_heads as _mla_mask_heads
from .mla import MLACfg, _latents, _queries, mla_apply, mla_decode
from .moe import combine_order, expert_ffn, mlp_apply, moe_route

__all__ = ["LMMesh", "Unit", "units"]


class Unit(NamedTuple):
    """One attention + FFN layer of the model, in forward order."""
    prefix: tuple   # its leaves' path: ("layers",), ("blocks", "local"), ...
    idx: tuple      # its index into their stacked axes
    attn: Any       # its AttnCfg or MLACfg
    ffn: str        # "mlp" or "moe"
    site: tuple     # its decode-cache subtree: (), ("local",), ("rest",), ...


def units(lm) -> list[Unit]:
    """The units of a dense or moe ``LM``; other families raise."""
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
        return [Unit(("first",), (), lm.mla_cfg, "mlp", ("first",))] + \
            [Unit(("layers",), (i,), lm.mla_cfg, "moe", ("rest",))
             for i in range(c.n_layers - c.first_dense)]
    raise ValueError(f"{c.name}: no mesh units for the {c.family} family")


def _cache_names(u: Unit) -> tuple:
    return ("ckv", "kpe") if isinstance(u.attn, MLACfg) else ("k", "v")


def _get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


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
    """Runs ``lm`` (a dense- or moe-family ``LM`` with a mesh) over its
    mesh: the ``loss`` / ``prefill`` / ``decode_step`` of the ``LM`` API,
    plus :meth:`logits` (every position's logits, gathered) and the MoE
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
        if path in self._plans:
            return self._plans[path]
        sh = self._leaf(path).sharding
        gdims = [i for i, e in enumerate(sh.spec)
                 if any(n != "model" for n in _names(e))]
        plan = None
        if gdims:
            axes = _names(sh.spec[gdims[0]])
            if len(gdims) > 1 or "model" in axes:
                raise NotImplementedError(
                    f"{'/'.join(path)} {sh.spec}: the mesh executor gathers "
                    f"one dimension split over axes other than model")
            groups: dict = {}
            for k in range(self.n):
                co = self.mesh.coords(k)
                key = tuple(v for a, v in co.items() if a not in axes)
                groups.setdefault(key, []).append((sh.block(k), k))
            plan = (gdims[0], [[k for _, k in sorted(g)]
                               for g in groups.values()])
        self._plans[path] = plan
        return plan

    def local(self, path: tuple, idx: tuple = ()) -> list:
        """Per member: leaf ``path`` at ``idx`` with every axis but
        ``model`` gathered (the member's model-axis slice, whole)."""
        views = [self._view(path, k, idx) for k in range(self.n)]
        plan = self._plan(path)
        if plan is None:
            return views
        dim, groups = plan
        out = [None] * self.n
        for g in groups:
            res = _Gather.apply(dim - len(idx), tuple(self.devs[k] for k in g),
                                *[views[k] for k in g])
            for k, r in zip(g, res):
                out[k] = r
        return out

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

    def heads(self, u: Unit) -> list:
        """Per member: the query heads it computes in unit ``u`` (a slice
        of the padded ``hq``; ``None``: all of them)."""
        q = "w_uq" if isinstance(u.attn, MLACfg) else "wq"
        return self._member_slice(u.prefix + ("attn", q), len(u.idx) + 1)

    def psum(self, parts: list) -> list:
        """Per member: the sum of its model group's ``parts``."""
        out = [None] * self.n
        for g in self.model_groups:
            if len(g) == 1:
                out[g[0]] = parts[g[0]]
                continue
            for k, r in zip(g, _AllReduce.apply(*[parts[k] for k in g])):
                out[k] = r
        return out

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
        hs = self._normed(u, "ln2", xs)
        if u.ffn == "mlp":
            w = self._tree(u, "mlp")
            ys = self.psum([mlp_apply(w[k], hs[k]) for k in range(self.n)])
        else:
            ys = self.moe(u, hs, rows)
        return [x + y for x, y in zip(xs, ys)]

    def _unit(self, u: Unit, xs: list, rows: list):
        """Unit ``u`` over the whole sequence → (xs', per-member cache
        pair: (k, v) or MLA's (c_kv, k_pe))."""
        hs = self._normed(u, "ln1", xs)
        p = self._tree(u, "attn")
        heads = self.heads(u)
        fn = mla_apply if isinstance(u.attn, MLACfg) else attn_apply
        parts, kvs = [], []
        for k in range(self.n):
            y, kv = fn(u.attn, p[k], hs[k], heads=heads[k])
            parts.append(y)
            kvs.append(kv)
        xs = [x + s for x, s in zip(xs, self.psum(parts))]
        return self._ffn(u, xs, rows), kvs

    def _hidden(self, batch: dict, emit_cache: bool = False):
        """→ (per-member final-normed hidden states, rows, per unit the
        per-member cache pairs, or None)."""
        lm, c = self.lm, self.lm.cfg
        tokens = torch.as_tensor(batch["tokens"])
        rows = self._rows(tokens.shape[0])
        xs = self._embed(self._split(tokens, rows))
        if c.prefix_len:
            pre = self._split(torch.as_tensor(batch["prefix"]), rows,
                              lm.dtype)
            xs = [torch.cat([p, x], dim=1) for p, x in zip(pre, xs)]
        remat = lm.remat and lm.trainable and torch.is_grad_enabled()
        outs = []
        for u in self.units:
            if remat:
                # reentrant: the backward re-runs the unit and backprops
                # through the new graph; the non-reentrant form matches
                # saved tensors by order, which a mesh of several devices
                # (one autograd thread each) was seen to break
                xs = list(checkpoint(
                    lambda *x, u=u: tuple(self._unit(u, list(x), rows)[0]),
                    *xs, use_reentrant=True))
            else:
                xs, kvs = self._unit(u, xs, rows)
                if emit_cache:
                    outs.append(kvs)
        norm = self.local(("final_norm",))
        xs = [rms_norm(x, norm[k], c.norm_eps) for k, x in enumerate(xs)]
        return xs, rows, (outs if emit_cache else None)

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
        """Per unit per-member cache pairs → the JAX prefill cache tree
        (dense ``(k, v)``; llama4 ``((k, v) local, (k, v) global)``;
        deepseek ``((c_kv, k_pe) first, (c_kv, k_pe) rest)``), each leaf a
        ShardedTensor: batch over the data axes where it divides, KV
        heads over ``model`` where the spec splits them."""
        lm = self.lm
        bspec = batch_axes(lm.rules, b, self.mesh)
        sites: dict = {}
        for u, kv in zip(self.units, outs):
            sites.setdefault(u.site, []).append((u, kv))
        tree = []
        for items in sites.values():
            u0 = items[0][0]
            lead = tuple(max(u.idx[d] for u, _ in items) + 1
                         for d in range(len(u0.idx)))
            pair = []
            for j in range(2):
                shards = []
                for k in range(self.n):
                    ts = [kv[k][j] for _, kv in items]
                    shards.append(torch.stack(ts).reshape(*lead, *ts[0].shape)
                                  if lead else ts[0])
                shape = list(shards[0].shape)
                spec = [None] * len(shape)
                spec[len(lead)] = bspec
                shape[len(lead)] = b
                if not isinstance(u0.attn, MLACfg):
                    shape[len(lead) + 2] = u0.attn.hkv
                    if lm.rules["kv_heads"] == "model":
                        spec[len(lead) + 2] = "model"
                pair.append(ShardedTensor(
                    NamedSharding(self.mesh, PartitionSpec(*spec)), shape,
                    shards))
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
                want = self.lm.cache_sharding(st.shape, b, bdim=len(u.idx))
                if tuple(want.spec) == tuple(st.sharding.spec):
                    work[path] = st
                else:
                    work[path] = ShardedTensor.from_full(
                        st.gather(self.lm.device), want)
        return work

    def _write_back(self, cache: dict, work: dict) -> None:
        for path, w in work.items():
            st = _get(cache, path)
            if w is not st:
                st.copy_(w.gather(self.lm.device))

    def _length_groups(self, st: ShardedTensor, sdim: int):
        """→ (per member its slice of the cache length, the length groups:
        members equal outside the axes that split the length, in length
        order; singletons where nothing splits it)."""
        sh = st.sharding
        axes = _names(sh.spec[sdim])
        span = [sh.member_index(k, st.shape)[sdim] for k in range(self.n)]
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
        na, nb = _cache_names(u)
        ca, cb = work[u.site + (na,)], work[u.site + (nb,)]
        span, groups = self._length_groups(ca, len(u.idx) + 1)
        if all(len(g) == 1 for g in groups):
            fn = mla_decode if isinstance(u.attn, MLACfg) else attn_decode
            parts = [fn(u.attn, p[k], hs[k], ca.shards[k][u.idx],
                        cb.shards[k][u.idx], pos, heads=heads[k])[0]
                     for k in range(self.n)]
        else:
            parts = self._seq_parallel(u, p, hs, ca, cb, pos, heads, span,
                                       groups)
        return [x + s for x, s in zip(xs, self.psum(parts))]

    def _seq_parallel(self, u: Unit, p: list, hs: list, ca, cb, pos: int,
                      heads: list, span: list, groups: list) -> list:
        """The decode attention over a length-sharded cache → per-member
        partial output projections (module docstring)."""
        c = u.attn
        mla = isinstance(c, MLACfg)
        s_cache = ca.shape[len(u.idx) + 1]
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
            else:
                q, new_a, new_b = _project_qkv(c, p[k], hs[k], at)
                write = decode_slot(c, s_cache, pos)
                qs.append(q)
            lo, hi = span[k].start, span[k].stop
            if lo <= write < hi:           # only the slot's holder writes
                ca.shards[k][u.idx][:, write - lo] = new_a[:, 0]
                cb.shards[k][u.idx][:, write - lo] = new_b[:, 0]
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
                a, b = ca.shards[k][u.idx], cb.shards[k][u.idx]
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
                else:
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
        rows = self._rows(token.shape[0])
        work = self._working(cache, token.shape[0])
        xs = self._embed(self._split(token, rows))
        for u in self.units:
            xs = self._attn_step(u, xs, work, pos)
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
