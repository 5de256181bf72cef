"""Architecture assembly (port of ``repro.models.model``): the dense
family (tinyllama-1.1b, qwen1.5-4b, qwen1.5-110b, starcoder2-7b and
internvl2-26b with its patch-embedding prefix), the ``ssm`` family
(mamba2-130m) and the ``hybrid`` family (zamba2-2.7b: mamba superblocks
with one shared attention + MLP block applied after each).

:class:`LM` is an ``nn.Module`` that holds its parameters; its methods
mirror the JAX ``LM``'s without the ``params`` argument:

- ``param_defs()`` / ``init(generator)``  — the JAX parameter tree's
  shapes, and seeded weights;
- ``loss(batch)``                         — next-token cross entropy and
  accuracy over the token positions (the train step's body);
- ``prefill(batch)``                      — full-sequence forward →
  (next token, the prefill cache: JAX's ``lax.scan`` outputs);
- ``init_cache(batch, cache_len)``        — zeroed decode cache;
- ``decode_step(cache, token, pos)``      — one-token greedy decode
  (argmax without softmax — the paper's tournament argmax).

Storage.  ``lm.params`` is the JAX parameter tree: one tensor per JAX
leaf, the layer axis stacked first (``layers``; ``blocks`` stacked
twice, ``(superblock, layer)``), so it flattens, checkpoints and
optimizes as the JAX tree does.  The modules the forward code reads —
``embed``, ``final_norm``, ``lm_head``, ``layers.{i}.ln1`` / ``ln2`` /
``ln``, ``layers.{i}.attn.{wq,wk,wv,wo,bq,bk,bv}``,
``layers.{i}.mlp.{w1,w2,w3}``, ``layers.{i}.mamba.{in_proj,...}``,
``blocks.{s}.{j}...``, ``shared...`` — hold parameters that are views of
those tensors.  Two constructor arguments set the storage:

- ``trainable=False`` (serving): matrices, biases and the embedding are
  stored in the compute dtype, vectors (norm weights, the mamba block's
  ``a_log`` / ``dt_bias`` / ``d_skip`` / ``conv_b``) in float32.  The
  JAX package keeps float32 leaves and casts each at use, which gives
  the same operand values.
- ``trainable=True``: every leaf float32 with ``requires_grad`` — the
  JAX package's float32 master weights, cast to the compute dtype at
  each use — and ``lm.grads``, a float32 tree shaped like
  ``lm.params`` that every parameter's ``.grad`` views, so
  ``loss.backward()`` accumulates each leaf's gradient there (zero it
  in place, never with ``zero_grad(set_to_none=True)``).

``remat=True`` (the JAX default) wraps each layer (a ``hybrid``
superblock as a whole) in ``torch.utils.checkpoint`` when a trainable
LM runs with autograd recording, where the JAX package's
``_maybe_remat`` wraps the scan body.

The ``moe`` and ``encdec`` families raise ``NotImplementedError``
(ROADMAP.md, queue 1).  ``input_specs`` and ``input_shardings`` come
with the sharding and dry-run slice.
"""

from __future__ import annotations

import itertools
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.popcount import argmax_tournament
from repro_torch.kernels.ops import resolve_device

from .attention import AttnCfg, attn_apply, attn_decode, attn_defs
from .common import ParamDef, draw_param, flatten_defs, rms_norm
from .mamba2 import MambaCfg, mamba_apply, mamba_decode, mamba_defs
from .moe import mlp_apply, mlp_defs

__all__ = ["LM"]

FAMILIES = ("dense", "ssm", "hybrid")


def _stack(defs, n: int):
    if isinstance(defs, ParamDef):
        return ParamDef((n, *defs.shape), ("layers", *defs.axes), defs.init,
                        defs.scale)
    return {k: _stack(v, n) for k, v in defs.items()}


def _norm_def(e: int) -> ParamDef:
    return ParamDef((e,), (None,), init="ones")


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class _Layer(nn.Module):
    """One layer's parameters (or the shared block's) under the JAX leaf
    names: vectors as attributes (``ln1``, ``ln``), each sub-block
    (``attn``, ``mlp``, ``mamba``) an ``nn.ParameterDict``."""

    def __init__(self, leaves: dict):
        super().__init__()
        for k, v in leaves.items():
            if isinstance(v, dict):
                setattr(self, k, nn.ParameterDict(v))
            else:
                self.register_parameter(k, v)


class LM(nn.Module):
    """An LM of a ported family at ``cfg``'s widths on ``device``
    (``None`` → cuda; raises where no GPU is visible), computing in
    ``dtype`` (the JAX ``compute_dtype``).  ``tp`` pads heads as the JAX
    ``LM`` does for a model axis of that size, so its parameter trees
    carry across.  ``trainable`` and ``remat``: see the module
    docstring."""

    def __init__(self, cfg: ModelConfig, *, tp: int = 1, device=None,
                 dtype=torch.bfloat16, trainable: bool = False,
                 remat: bool = True):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported yet "
                f"(ROADMAP.md, queue 1, item 7); the port runs the "
                f"{', '.join(FAMILIES)} families")
        self.cfg = cfg
        self.tp = tp
        self.dtype = dtype
        self.trainable = trainable
        self.remat = remat
        self.device = resolve_device(device)
        c = cfg
        if c.family in ("dense", "hybrid"):
            self.attn_cfg = AttnCfg(
                c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
                qkv_bias=c.qkv_bias if c.family == "dense" else False,
                rope_theta=c.rope_theta,
                window=c.window if c.family == "dense" else 0, chunk=0, tp=tp)
        if c.family in ("ssm", "hybrid"):
            self.mamba_cfg = MambaCfg(
                c.d_model, d_state=c.ssm_state, head_dim=c.ssm_head_dim,
                expand=c.ssm_expand, conv_kernel=c.conv_kernel,
                chunk=c.ssm_chunk, norm_eps=c.norm_eps)
        self._allocate()

    # ------------------------------------------------------------ param defs
    def _layer_defs(self) -> dict:
        c, e = self.cfg, self.cfg.d_model
        if c.family == "dense":
            return {"ln1": _norm_def(e), "ln2": _norm_def(e),
                    "attn": attn_defs(self.attn_cfg),
                    "mlp": mlp_defs(e, c.d_ff)}
        return {"ln": _norm_def(e), "mamba": mamba_defs(self.mamba_cfg)}

    def param_defs(self) -> dict:
        """The JAX ``LM.param_defs()`` tree: layers stacked on a leading
        axis (``blocks`` on two), as the JAX package stores them."""
        c = self.cfg
        e, vp = c.d_model, c.padded_vocab
        defs: dict[str, Any] = {
            "embed": ParamDef((vp, e), ("vocab", "embed"), scale=0.02),
            "final_norm": _norm_def(e),
        }
        if not c.tie_embeddings:
            defs["lm_head"] = ParamDef((e, vp), ("embed", "vocab"))
        if c.family == "hybrid":
            nsb = c.n_layers // c.shared_attn_every
            defs["blocks"] = _stack(_stack(self._layer_defs(),
                                           c.shared_attn_every), nsb)
            defs["shared"] = {"ln1": _norm_def(e), "ln2": _norm_def(e),
                              "attn": attn_defs(self.attn_cfg),
                              "mlp": mlp_defs(e, c.d_ff)}
        else:
            defs["layers"] = _stack(self._layer_defs(), c.n_layers)
        return defs

    def _allocate(self) -> None:
        """One tensor per JAX leaf (``self.params``), per-layer parameter
        views of it in the modules, and with ``trainable`` the gradient
        tree ``self.grads`` that the parameters' ``.grad`` view."""
        self.params: dict = {}
        self.grads: dict | None = {} if self.trainable else None
        top: dict = {}
        per: dict = {}                 # layer index tuple → leaves
        for path, d in flatten_defs(self.param_defs()):
            n_stack = 0
            while n_stack < len(d.axes) and d.axes[n_stack] == "layers":
                n_stack += 1
            vector = len(d.shape) - n_stack <= 1
            dt = torch.float32 if self.trainable or vector else self.dtype
            buf = torch.empty(d.shape, dtype=dt, device=self.device)
            grad = torch.zeros_like(buf) if self.trainable else None
            if n_stack == 0:
                buf = nn.Parameter(buf, requires_grad=self.trainable)
                buf.grad = grad
                _set(top, path, buf)
            else:
                for idx in itertools.product(*map(range, d.shape[:n_stack])):
                    p = nn.Parameter(buf[idx], requires_grad=self.trainable)
                    if grad is not None:
                        p.grad = grad[idx]
                    _set(per.setdefault(idx, {}), path[1:], p)
            _set(self.params, path, buf)
            if grad is not None:
                _set(self.grads, path, grad)
        for name in ("embed", "final_norm", "lm_head"):
            if name in top:
                self.register_parameter(name, top[name])
        c = self.cfg
        if c.family == "hybrid":
            k = c.shared_attn_every
            self.blocks = nn.ModuleList(
                nn.ModuleList(_Layer(per[(s, j)]) for j in range(k))
                for s in range(c.n_layers // k))
            self.shared = _Layer(top["shared"])
        else:
            self.layers = nn.ModuleList(_Layer(per[(i,)])
                                        for i in range(c.n_layers))

    def leaf_parameters(self, path: tuple) -> list[nn.Parameter]:
        """The parameters that view the JAX leaf at ``path``: one per
        layer, in stacking order, for a ``layers`` / ``blocks`` leaf."""
        name = ".".join(path[1:])
        if path[0] == "layers":
            return [layer.get_parameter(name) for layer in self.layers]
        if path[0] == "blocks":
            return [layer.get_parameter(name) for blk in self.blocks
                    for layer in blk]
        return [self.get_parameter(".".join(path))]

    @torch.no_grad()
    def load_leaf(self, path: tuple, value: torch.Tensor) -> None:
        """Copy one JAX-layout leaf (stacked for ``layers`` / ``blocks``)
        into ``self.params``, cast to its dtype and device."""
        _get(self.params, path).copy_(value)

    def init(self, generator: torch.Generator) -> "LM":
        """Seeded weights: each leaf of :meth:`param_defs` drawn in
        ``jax.tree.flatten`` order from ``generator`` (float32, on the
        generator's device), then stored.  Returns ``self``."""
        for path, d in flatten_defs(self.param_defs()):
            self.load_leaf(path, draw_param(d, generator))
        return self

    # ------------------------------------------------------------- embedding
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.long()].to(self.dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ head`` in the compute dtype, then float32; the padded
        vocabulary's columns are ``-1e30``."""
        c = self.cfg
        head = self.embed.T if c.tie_embeddings else self.lm_head
        logits = (x @ head.to(x.dtype)).float()
        if c.padded_vocab != c.vocab_size:
            logits[..., c.vocab_size:] = -1e30
        return logits

    # ---------------------------------------------------------------- layers
    def _layer(self, lp: _Layer, x: torch.Tensor):
        """One dense layer over the whole sequence → (x', (k, v))."""
        eps = self.cfg.norm_eps
        a, kv = attn_apply(self.attn_cfg, lp.attn, rms_norm(x, lp.ln1, eps))
        x = x + a
        return x + mlp_apply(lp.mlp, rms_norm(x, lp.ln2, eps)), kv

    def _mamba_layer(self, lp: _Layer, x: torch.Tensor):
        """One mamba layer over the whole sequence → (x', (conv_state,
        ssm_state))."""
        y, st = mamba_apply(self.mamba_cfg, lp.mamba,
                            rms_norm(x, lp.ln, self.cfg.norm_eps))
        return x + y, st

    def _superblock(self, bp: nn.ModuleList, x: torch.Tensor):
        """A hybrid superblock: its mamba layers, then the shared block
        → (x', ((conv, ssm) stacked over the layers, (k, v)))."""
        sts = []
        for lp in bp:
            x, st = self._mamba_layer(lp, x)
            sts.append(st)
        x, kv = self._layer(self.shared, x)
        return x, (tuple(torch.stack(t) for t in zip(*sts)), kv)

    def _forward(self, tokens: torch.Tensor, *, prefix=None,
                 emit_cache: bool = False):
        """→ (hidden (B,S,E), cache-or-None). S includes any prefix.
        The cache is the JAX scan's output: dense ``(k, v)`` each
        (L, B, S, hkv, D); ssm ``(conv, ssm)``; hybrid ``((conv, ssm)
        each (nsb, k, ...), (k, v) each (nsb, B, S, hkv, D))``."""
        c = self.cfg
        x = self._embed(tokens)
        if prefix is not None:
            x = torch.cat([prefix.to(self.dtype), x], dim=1)
        remat = self.remat and self.trainable and torch.is_grad_enabled()

        def call(fn, lp, x):
            if remat:
                return checkpoint(fn, lp, x, use_reentrant=False)
            return fn(lp, x)

        if c.family == "hybrid":
            body, stack = self._superblock, self.blocks
        elif c.family == "ssm":
            body, stack = self._mamba_layer, self.layers
        else:
            body, stack = self._layer, self.layers
        outs = []
        for lp in stack:
            x, out = call(body, lp, x)
            if emit_cache:
                outs.append(out)
        x = rms_norm(x, self.final_norm, c.norm_eps)
        if not emit_cache:
            return x, None
        if c.family == "hybrid":
            sts, kvs = zip(*outs)
            return x, (tuple(torch.stack(t) for t in zip(*sts)),
                       tuple(torch.stack(t) for t in zip(*kvs)))
        return x, tuple(torch.stack(t) for t in zip(*outs))

    # ------------------------------------------------------------------ loss
    def loss(self, batch: dict):
        """Next-token cross entropy over ``batch["tokens"]`` (B, S)
        against ``batch["targets"]`` (B, S) (plus ``batch["prefix"]``
        where the config has one; the loss covers token positions only)
        → (loss, {"loss", "acc"}), float32 scalars.

        As the JAX function: the max through a stop-gradient, then
        log-sum-exp, then the one-hot contraction; ``acc`` uses argmax's
        first-index tie rule.  The padded vocabulary's ``-1e30`` columns
        get zero gradient."""
        c = self.cfg
        kw = {"prefix": batch["prefix"]} if c.prefix_len else {}
        h, _ = self._forward(batch["tokens"], **kw)
        if c.prefix_len:                  # loss only over token positions
            h = h[:, c.prefix_len:]
        logits = self._logits(h)
        tgt = batch["targets"].long()
        m = logits.max(-1, keepdim=True).values.detach()
        lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
        onehot = F.one_hot(tgt, logits.shape[-1]).to(logits.dtype)
        lt = torch.einsum("bsv,bsv->bs", logits, onehot)
        loss = (lse - lt).mean()
        acc = (logits.argmax(-1) == tgt).float().mean()
        return loss, {"loss": loss.detach(), "acc": acc}

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, batch: dict):
        """``batch["tokens"]`` (B, S) (and ``batch["prefix"]``
        (B, P, E) where the config has a prefix) → (next token (B,)
        int32, the prefill cache of :meth:`_forward`)."""
        kw = {"emit_cache": True}
        if self.cfg.prefix_len:
            kw["prefix"] = batch["prefix"]
        h, cache = self._forward(batch["tokens"], **kw)
        logits = self._logits(h[:, -1:])
        return argmax_tournament(logits[:, 0]), cache

    # ------------------------------------------------------------ decode API
    def init_cache(self, batch: int, cache_len: int, dtype=None) -> dict:
        """Zeroed decode cache, as the JAX ``init_cache``: dense
        ``{"k", "v"}`` each (L, B, len, hkv, D) (a sliding-window config
        keeps ``min(window, cache_len)`` slots); ssm ``{"conv" (L, B,
        conv_dim, K−1), "ssm" (L, B, H, P, N) float32}``; hybrid the same
        with (nsb, k) leading axes plus ``"attn": {"k", "v"}`` each
        (nsb, B, len, hkv, D)."""
        c = self.cfg
        dt = dtype or self.dtype

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        def kv(n, length):
            a = self.attn_cfg
            return {"k": zeros(n, batch, length, a.hkv, a.head_dim),
                    "v": zeros(n, batch, length, a.hkv, a.head_dim)}

        if c.family == "dense":
            return kv(c.n_layers,
                      min(c.window, cache_len) if c.window else cache_len)
        m = self.mamba_cfg
        lead = (c.n_layers,) if c.family == "ssm" else \
            (c.n_layers // c.shared_attn_every, c.shared_attn_every)
        out = {"conv": zeros(*lead, batch, m.conv_dim, m.conv_kernel - 1),
               "ssm": zeros(*lead, batch, m.n_heads, m.head_dim, m.d_state,
                            dtype=torch.float32)}
        if c.family == "hybrid":
            out["attn"] = kv(lead[0], cache_len)
        return out

    def _decode_layer(self, lp: _Layer, x: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      pos: int) -> torch.Tensor:
        """One dense layer (or the shared block) for one token
        (B, 1, E), its keys and values written into the layer's cache
        (B, S_cache, hkv, D) at ``pos``."""
        eps = self.cfg.norm_eps
        a, _, _ = attn_decode(self.attn_cfg, lp.attn,
                              rms_norm(x, lp.ln1, eps), cache_k, cache_v,
                              pos)
        x = x + a
        return x + mlp_apply(lp.mlp, rms_norm(x, lp.ln2, eps))

    def _mamba_decode_layer(self, lp: _Layer, x: torch.Tensor,
                            conv: torch.Tensor,
                            ssm: torch.Tensor) -> torch.Tensor:
        """One mamba layer for one token (B, 1, E), its states written
        into ``conv`` (B, conv_dim, K−1) and ``ssm`` (B, H, P, N)."""
        y, cs, ss = mamba_decode(self.mamba_cfg, lp.mamba,
                                 rms_norm(x, lp.ln, self.cfg.norm_eps),
                                 conv, ssm)
        conv.copy_(cs)
        ssm.copy_(ss)
        return x + y

    @torch.no_grad()
    def _decode_hidden(self, cache: dict, token: torch.Tensor,
                       pos: int) -> torch.Tensor:
        """The final-normed hidden state (B, 1, E) of one decode step;
        writes the step's keys, values and states into ``cache``."""
        c = self.cfg
        pos = int(pos)
        x = self._embed(token)
        if c.family == "dense":
            for i, lp in enumerate(self.layers):
                x = self._decode_layer(lp, x, cache["k"][i], cache["v"][i],
                                       pos)
        elif c.family == "ssm":
            for i, lp in enumerate(self.layers):
                x = self._mamba_decode_layer(lp, x, cache["conv"][i],
                                             cache["ssm"][i])
        else:
            for s, bp in enumerate(self.blocks):
                for j, lp in enumerate(bp):
                    x = self._mamba_decode_layer(lp, x, cache["conv"][s, j],
                                                 cache["ssm"][s, j])
                x = self._decode_layer(self.shared, x, cache["attn"]["k"][s],
                                       cache["attn"]["v"][s], pos)
        return rms_norm(x, self.final_norm, c.norm_eps)

    def decode_step(self, cache: dict, token: torch.Tensor, pos):
        """token (B,1) int, pos an int → (next_token (B,) int32, cache).

        The cache is updated in place and returned (the JAX method
        returns a new one)."""
        x = self._decode_hidden(cache, token, pos)
        logits = self._logits(x)
        return argmax_tournament(logits[:, 0]), cache    # no softmax (paper)
