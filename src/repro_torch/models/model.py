"""Architecture assembly (port of ``repro.models.model``), the dense
family: tinyllama-1.1b, qwen1.5-4b, qwen1.5-110b, starcoder2-7b and
internvl2-26b (with its patch-embedding prefix).

:class:`LM` is an ``nn.Module`` that holds its parameters; its methods
mirror the JAX ``LM``'s without the ``params`` argument:

- ``param_defs()`` / ``init(generator)``  — the JAX parameter tree's
  shapes, and seeded weights;
- ``prefill(batch)``                      — full-sequence forward →
  (next token, ``(k, v)`` cache stacked on the layer axis);
- ``init_cache(batch, cache_len)``        — zeroed decode cache;
- ``decode_step(cache, token, pos)``      — one-token greedy decode
  (argmax without softmax — the paper's tournament argmax).

Parameter names are the JAX leaf names, one submodule per layer:
``embed``, ``final_norm``, ``lm_head``, ``layers.{i}.ln1`` / ``ln2``,
``layers.{i}.attn.{wq,wk,wv,wo,bq,bk,bv}``, ``layers.{i}.mlp.{w1,w2,w3}``.
Matrices, biases and the embedding are stored in the compute dtype: the
JAX package keeps float32 leaves and casts each at use, which gives the
same operand values.  Norm weights stay float32 (``rms_norm`` multiplies
in float32).

Families other than ``dense`` raise ``NotImplementedError`` (ROADMAP.md,
queue 1).  ``loss``, ``remat``, ``input_specs`` and ``input_shardings``
come with the training and dry-run slices.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.popcount import argmax_tournament
from repro_torch.kernels.ops import resolve_device

from .attention import AttnCfg, attn_apply, attn_decode, attn_defs
from .common import ParamDef, draw_param, flatten_defs, rms_norm
from .moe import mlp_apply, mlp_defs

__all__ = ["LM"]


def _stack(defs, n: int):
    if isinstance(defs, ParamDef):
        return ParamDef((n, *defs.shape), ("layers", *defs.axes), defs.init,
                        defs.scale)
    return {k: _stack(v, n) for k, v in defs.items()}


def _norm_def(e: int) -> ParamDef:
    return ParamDef((e,), (None,), init="ones")


def _empty(d: ParamDef, dtype, device) -> nn.Parameter:
    """An uninitialised leaf: norm weights (``init="ones"``) in float32,
    every other leaf in the compute dtype."""
    dt = torch.float32 if d.init == "ones" else dtype
    return nn.Parameter(torch.empty(d.shape, dtype=dt, device=device),
                        requires_grad=False)


class _DenseLayer(nn.Module):
    """One pre-norm block: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, defs: dict, dtype, device):
        super().__init__()
        self.ln1 = _empty(defs["ln1"], dtype, device)
        self.ln2 = _empty(defs["ln2"], dtype, device)
        self.attn = nn.ParameterDict(
            {k: _empty(d, dtype, device) for k, d in defs["attn"].items()})
        self.mlp = nn.ParameterDict(
            {k: _empty(d, dtype, device) for k, d in defs["mlp"].items()})


class LM(nn.Module):
    """A dense-family LM at ``cfg``'s widths on ``device`` (``None`` →
    cuda; raises where no GPU is visible), computing in ``dtype`` (the
    JAX ``compute_dtype``).  ``tp`` pads heads as the JAX ``LM`` does
    for a model axis of that size, so its parameter trees carry across."""

    def __init__(self, cfg: ModelConfig, *, tp: int = 1, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported yet "
                f"(ROADMAP.md, queue 1, item 7); the port serves the dense "
                f"family")
        self.cfg = cfg
        self.tp = tp
        self.dtype = dtype
        self.device = resolve_device(device)
        self.attn_cfg = AttnCfg(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta,
            window=cfg.window, chunk=0, tp=tp)
        defs = self.param_defs()
        self.embed = _empty(defs["embed"], dtype, self.device)
        self.final_norm = _empty(defs["final_norm"], dtype, self.device)
        if not cfg.tie_embeddings:
            self.lm_head = _empty(defs["lm_head"], dtype, self.device)
        layer = self._layer_defs()
        self.layers = nn.ModuleList(
            _DenseLayer(layer, dtype, self.device)
            for _ in range(cfg.n_layers))

    # ------------------------------------------------------------ param defs
    def _layer_defs(self) -> dict:
        e = self.cfg.d_model
        return {"ln1": _norm_def(e), "ln2": _norm_def(e),
                "attn": attn_defs(self.attn_cfg),
                "mlp": mlp_defs(e, self.cfg.d_ff)}

    def param_defs(self) -> dict:
        """The JAX ``LM.param_defs()`` tree: layers stacked on a leading
        axis, as the JAX package stores them."""
        c = self.cfg
        e, vp = c.d_model, c.padded_vocab
        defs: dict[str, Any] = {
            "embed": ParamDef((vp, e), ("vocab", "embed"), scale=0.02),
            "final_norm": _norm_def(e),
        }
        if not c.tie_embeddings:
            defs["lm_head"] = ParamDef((e, vp), ("embed", "vocab"))
        defs["layers"] = _stack(self._layer_defs(), c.n_layers)
        return defs

    def leaf_parameters(self, path: tuple) -> list[nn.Parameter]:
        """The parameters that hold the JAX leaf at ``path``: one per
        layer, in layer order, for a ``("layers", ...)`` leaf."""
        if path[0] == "layers":
            name = ".".join(path[1:])
            return [layer.get_parameter(name) for layer in self.layers]
        return [self.get_parameter(".".join(path))]

    @torch.no_grad()
    def load_leaf(self, path: tuple, value: torch.Tensor) -> None:
        """Copy one JAX-layout leaf (stacked for ``layers``) into the
        module, casting to each parameter's dtype and device."""
        params = self.leaf_parameters(path)
        if path[0] == "layers":
            for p, v in zip(params, value.unbind(0)):
                p.copy_(v)
        else:
            params[0].copy_(value)

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

    # ---------------------------------------------------------------- dense
    def _layer(self, lp: _DenseLayer, x: torch.Tensor):
        """One layer over the whole sequence → (x', (k, v))."""
        eps = self.cfg.norm_eps
        a, kv = attn_apply(self.attn_cfg, lp.attn, rms_norm(x, lp.ln1, eps))
        x = x + a
        return x + mlp_apply(lp.mlp, rms_norm(x, lp.ln2, eps)), kv

    @torch.no_grad()
    def _forward(self, tokens: torch.Tensor, *, prefix=None,
                 emit_cache: bool = False):
        """→ (hidden (B,S,E), cache-or-None). S includes any prefix; the
        cache is ``(k, v)``, each ``(L, B, S, hkv, D)``."""
        x = self._embed(tokens)
        if prefix is not None:
            x = torch.cat([prefix.to(self.dtype), x], dim=1)
        ks, vs = [], []
        for lp in self.layers:
            x, (k, v) = self._layer(lp, x)
            if emit_cache:
                ks.append(k)
                vs.append(v)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x, ((torch.stack(ks), torch.stack(vs)) if emit_cache
                   else None)

    def prefill(self, batch: dict):
        """``batch["tokens"]`` (B, S) (and ``batch["prefix"]``
        (B, P, E) where the config has a prefix) → (next token (B,)
        int32, ``(k, v)`` cache stacked on the layer axis)."""
        kw = {"emit_cache": True}
        if self.cfg.prefix_len:
            kw["prefix"] = batch["prefix"]
        h, cache = self._forward(batch["tokens"], **kw)
        logits = self._logits(h[:, -1:])
        return argmax_tournament(logits[:, 0]), cache

    # ------------------------------------------------------------ decode API
    def init_cache(self, batch: int, cache_len: int, dtype=None) -> dict:
        """Zeroed decode cache ``{"k", "v"}``, each (L, B, len, hkv, D);
        a sliding-window config keeps ``min(window, cache_len)`` slots."""
        c, a = self.cfg, self.attn_cfg
        length = min(c.window, cache_len) if c.window else cache_len
        shp = (c.n_layers, batch, length, a.hkv, a.head_dim)
        dt = dtype or self.dtype
        return {"k": torch.zeros(shp, dtype=dt, device=self.device),
                "v": torch.zeros(shp, dtype=dt, device=self.device)}

    def _decode_layer(self, lp: _DenseLayer, x: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      pos: int) -> torch.Tensor:
        """One layer for one token (B, 1, E), its keys and values written
        into the layer's cache (B, S_cache, hkv, D) at ``pos``."""
        eps = self.cfg.norm_eps
        a, _, _ = attn_decode(self.attn_cfg, lp.attn,
                              rms_norm(x, lp.ln1, eps), cache_k, cache_v,
                              pos)
        x = x + a
        return x + mlp_apply(lp.mlp, rms_norm(x, lp.ln2, eps))

    @torch.no_grad()
    def _decode_hidden(self, cache: dict, token: torch.Tensor,
                       pos: int) -> torch.Tensor:
        """The final-normed hidden state (B, 1, E) of one decode step;
        writes the step's keys and values into ``cache``."""
        pos = int(pos)
        x = self._embed(token)
        for i, lp in enumerate(self.layers):
            x = self._decode_layer(lp, x, cache["k"][i], cache["v"][i], pos)
        return rms_norm(x, self.final_norm, self.cfg.norm_eps)

    def decode_step(self, cache: dict, token: torch.Tensor, pos):
        """token (B,1) int, pos an int → (next_token (B,) int32, cache).

        The cache is updated in place and returned (the JAX method
        returns a new one)."""
        x = self._decode_hidden(cache, token, pos)
        logits = self._logits(x)
        return argmax_tournament(logits[:, 0]), cache    # no softmax (paper)
