"""The dense family over a device mesh: what GSPMD does with the LM's
specs, written out for a single process (the port's counterpart of
``jax.jit`` with ``param_shardings`` / ``input_shardings`` on a
``("data", "model")`` or ``("pod", "data", "model")`` mesh).

Every member of ``lm.mesh`` holds only its shards (``lm.params`` leaves
are :class:`~repro_torch.distributed.sharding.ShardedTensor`\\ s) and
computes on its own device; one thread launches each member's work in
turn, so a mesh that repeats one device runs its members one after
another (more launches and copies, no speedup).  Per layer:

- the batch rows are split over the ``pod`` / ``data`` members where
  the batch divides their extent (:func:`batch_axes`), else every
  member holds them all;
- a leaf whose ``embed`` dimension is split over ``data`` (FSDP) is
  gathered across the data members of its model column before use: a
  bitwise ``.to()`` and a concatenation in member order
  (:class:`_Gather`, whose backward sums the members' gradients of each
  slice in member order: the reduce-scatter);
- each ``model`` member computes its query heads (heads are padded to
  ``tp`` by ``AttnCfg``), their keys and values (all KV heads where the
  model extent does not divide them: the spec keeps them replicated),
  the attention over them and its partial output projection; the SwiGLU
  MLP its columns of ``w1`` / ``w3`` and rows of ``w2``.  The partials
  are summed in fixed member order on each member (:class:`_AllReduce`);
- the embedding lookup and the head are split over ``vocab``: each
  member looks up the tokens in its rows (the others give zeros, summed
  as above); the served token is the tournament argmax of the members'
  tournament picks (the first maximum wins, as
  ``core.popcount.argmax_tournament``); the loss combines the members'
  sums of ``exp(logits − max)`` and target logits in fixed order, as
  the vocab-sharded cross entropy of the JAX ``LM.loss`` does.

Gradients: each member's view of a stacked leaf is a parameter whose
``.grad`` views that member's shard of ``lm.grads``; after the backward
pass :meth:`DenseMesh.reduce_grads` sums the copies of a replicated
slice in member order (norm weights, replicated KV projections).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.popcount import argmax_tournament
from repro_torch.distributed.sharding import (NamedSharding, PartitionSpec,
                                              ShardedTensor, _names,
                                              batch_axes)
from repro_torch.tree import leaves as _leaves

from .attention import attn_apply, attn_decode
from .common import rms_norm
from .moe import mlp_apply

__all__ = ["DenseMesh"]


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


class DenseMesh:
    """Runs ``lm`` (a dense-family ``LM`` with a mesh) over its mesh: the
    ``loss`` / ``prefill`` / ``decode_step`` of the ``LM`` API, plus
    :meth:`logits` (every position's logits, gathered) for tests."""

    def __init__(self, lm):
        mesh = lm.mesh
        tpn = mesh.shape.get("model", 1)
        if lm.tp != tpn:
            raise ValueError(f"LM(tp={lm.tp}) on a mesh whose model axis has "
                             f"{tpn} members: pass tp={tpn}")
        self.lm, self.mesh = lm, mesh
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
        # the query heads each member computes (None: all of them)
        wq = lm.params["layers"]["attn"]["wq"]
        self.heads = [None if wq.sharding.shard_shape(wq.shape)[2] ==
                      lm.attn_cfg.hq else
                      wq.sharding.member_index(k, wq.shape)[2]
                      for k in range(self.n)]
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
        t = self.lm.params if tree is None else tree
        for k in path:
            t = t[k]
        return t

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
                    f"{'/'.join(path)} {sh.spec}: a dimension split over "
                    f"model and another axis (ROADMAP.md, queue 1, item "
                    f"7f-ii)")
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
            for k in g:
                m = parts[g[0]].to(self.devs[k])
                for j in g[1:]:
                    m = torch.maximum(m, parts[j].to(self.devs[k]))
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

    def _attn_weights(self, i: int) -> list:
        names = ["wq", "wk", "wv", "wo"]
        if self.lm.cfg.qkv_bias:
            names += ["bq", "bk", "bv"]
        cols = {n: self.local(("layers", "attn", n), (i,)) for n in names}
        return [{n: cols[n][k] for n in names} for k in range(self.n)]

    def _mlp(self, i: int, xs: list) -> list:
        eps = self.lm.cfg.norm_eps
        ln2 = self.local(("layers", "ln2"), (i,))
        w = {n: self.local(("layers", "mlp", n), (i,))
             for n in ("w1", "w3", "w2")}
        parts = [mlp_apply({n: w[n][k] for n in w},
                           rms_norm(xs[k], ln2[k], eps))
                 for k in range(self.n)]
        return [x + s for x, s in zip(xs, self.psum(parts))]

    def _layer(self, i: int, xs: list):
        """Layer ``i`` over the whole sequence → (xs', per-member (k, v))."""
        eps = self.lm.cfg.norm_eps
        ln1 = self.local(("layers", "ln1"), (i,))
        p = self._attn_weights(i)
        parts, kvs = [], []
        for k in range(self.n):
            y, kv = attn_apply(self.lm.attn_cfg, p[k],
                               rms_norm(xs[k], ln1[k], eps),
                               heads=self.heads[k])
            parts.append(y)
            kvs.append(kv)
        xs = [x + s for x, s in zip(xs, self.psum(parts))]
        return self._mlp(i, xs), kvs

    def _hidden(self, batch: dict, emit_cache: bool = False):
        """→ (per-member final-normed hidden states, rows, per-member
        stacked (k, v) or None)."""
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
        for i in range(c.n_layers):
            if remat:
                # reentrant: the backward re-runs the layer and backprops
                # through the new graph; the non-reentrant form matches
                # saved tensors by order, which a mesh of several devices
                # (one autograd thread each) was seen to break
                xs = list(checkpoint(
                    lambda *x, i=i: tuple(self._layer(i, list(x))[0]),
                    *xs, use_reentrant=True))
            else:
                xs, kvs = self._layer(i, xs)
                if emit_cache:
                    outs.append(kvs)
        norm = self.local(("final_norm",))
        xs = [rms_norm(x, norm[k], c.norm_eps) for k, x in enumerate(xs)]
        cache = None
        if emit_cache:
            cache = [tuple(torch.stack([o[k][j] for o in outs])
                           for j in range(2)) for k in range(self.n)]
        return xs, rows, cache

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
        """→ (next token (B,) int32, the prefill cache ``(k, v)``, each a
        ShardedTensor (L, B, S, hkv, D))."""
        xs, rows, kvs = self._hidden(batch, emit_cache=True)
        tok = self._pick([lg[:, 0] for lg in
                          self._logits([x[:, -1:] for x in xs])])
        lm, a = self.lm, self.lm.attn_cfg
        b = torch.as_tensor(batch["tokens"]).shape[0]
        kvspec = "model" if lm.rules["kv_heads"] == "model" else None
        sh = NamedSharding(self.mesh, PartitionSpec(
            None, batch_axes(lm.rules, b, self.mesh), None, kvspec, None))
        shape = (lm.cfg.n_layers, b, xs[0].shape[1], a.hkv, a.head_dim)
        cache = tuple(ShardedTensor(sh, shape, [kvs[k][j]
                                                for k in range(self.n)])
                      for j in range(2))
        return self._join(tok, rows), cache

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
        lm, c = self.lm, self.lm.cfg
        pos = int(pos)
        token = torch.as_tensor(token)
        rows = self._rows(token.shape[0])
        xs = self._embed(self._split(token, rows))
        ck, cv = cache["k"], cache["v"]
        for i in range(c.n_layers):
            ln1 = self.local(("layers", "ln1"), (i,))
            p = self._attn_weights(i)
            parts = []
            for k in range(self.n):
                y, _, _ = attn_decode(lm.attn_cfg, p[k],
                                      rms_norm(xs[k], ln1[k], c.norm_eps),
                                      ck.shards[k][i], cv.shards[k][i], pos,
                                      heads=self.heads[k])
                parts.append(y)
            xs = [x + s for x, s in zip(xs, self.psum(parts))]
            xs = self._mlp(i, xs)
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
