"""Architecture assembly (port of ``repro.models.model``): every family
of the LM zoo —

- ``dense``: tinyllama-1.1b, qwen1.5-4b, qwen1.5-110b, starcoder2-7b and
  internvl2-26b with its patch-embedding prefix;
- ``moe``: llama4-scout (superblocks of ``global_every − 1``
  chunked-local attention layers and one global NoPE layer, each with
  routed experts) and deepseek-v2 (MLA attention, a dense first layer,
  then routed experts);
- ``ssm``: mamba2-130m;
- ``hybrid``: zamba2-2.7b (mamba superblocks with one shared attention
  + MLP block applied after each);
- ``encdec``: seamless-m4t-large-v2 (a bidirectional encoder over
  ``frames``, a decoder with self- and cross-attention).

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

As in the reference, a ``moe`` layer computes its prefill and its
decode step with different expert capacities (``T = B·S`` tokens
against ``T = B``; ROADMAP.md, R7), and an ``encdec`` decode step
attends to the cache's ``xk`` / ``xv``, which ``init_cache`` zeroes and
``generate`` never fills (R6).

Storage.  ``lm.params`` is the JAX parameter tree: one tensor per JAX
leaf, the layer axes stacked first (``layers`` and ``encoder`` once;
zamba2's ``blocks`` twice, ``(superblock, layer)``; llama4's
``blocks/local`` twice, ``(superblock, local layer)``, and
``blocks/global`` once), so it flattens, checkpoints and optimizes as
the JAX tree does.  The modules the forward code reads hold parameters
that are views of those tensors, nested as the JAX tree nests them,
each stacked axis a ``ModuleList``: ``embed``, ``final_norm``,
``lm_head``, ``layers[i].ln1`` / ``.attn["wq"]`` / ``.mlp`` /
``.moe["shared"]["w1"]`` / ``.mamba``, ``blocks[s][j]`` (zamba2),
``blocks[s].local[j]`` and ``blocks[s]["global"]`` (llama4), ``first``
(deepseek), ``encoder[i]``, ``enc_norm``, ``shared``.  Two constructor
arguments set the storage:

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

``remat=True`` (the JAX default) wraps each scanned body of the JAX
package (a layer, the encoder's too, not deepseek's unscanned first
layer; a ``hybrid`` or llama4 superblock as a whole) in
``torch.utils.checkpoint`` when a trainable LM runs with autograd
recording, where the JAX package's ``_maybe_remat`` wraps it.

Sharding.  ``LM(cfg, tp=, mesh=)`` builds ``self.rules`` and the
constrainer ``self._c`` as the JAX ``__init__`` does (``kv_heads`` and
the mamba axes demoted where they cannot divide ``tp``; ``kv_seq`` set);
``param_specs()`` / ``param_shardings()`` and ``input_specs(shape)`` /
``input_shardings(shape)`` are the JAX methods' (``input_specs`` gives
meta-device stand-ins, nothing allocated).  With a ``mesh``, each leaf
of ``lm.params`` (and ``lm.grads``) is a
:class:`~repro_torch.distributed.sharding.ShardedTensor`: one tensor per
mesh member, the slice its spec gives that member, on its device;
``gather_params()`` returns the JAX layout.  The ``dense`` family then
runs over the mesh (:mod:`.sharded`): batch over ``pod``/``data``,
heads, MLP columns and vocabulary over ``model``, the ``embed`` dimension
gathered over ``data`` before use (FSDP), and so does every other
family: ``moe`` with its experts split over ``model`` (expert
parallelism, routing once over the global tokens) and MLA's heads over
``model``; ``ssm`` / ``hybrid`` with each mamba layer's ``in_proj``
columns over ``model`` (the activation blocks gathered), its SSM state
split along ``P`` and its conv state along its channels as their cache
specs store them, zamba2's shared block a dense unit at each
superblock's cache site; ``encdec`` with the encoder's bidirectional
layers and the cross-attention's heads over ``model``, ``xk`` / ``xv``
read under their spec and never written (R6).  A decode cache whose
spec shards its length runs sequence-parallel; ``init_cache`` returns
every leaf as a ShardedTensor under ``input_shardings``.  Every family
trains on a mesh: ``loss`` backpropagates through the mesh's exchanges
into each member's gradient shards (:mod:`.sharded`).
"""

from __future__ import annotations

import itertools
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.popcount import argmax_tournament
from repro_torch.distributed.sharding import (NamedSharding, ShardedTensor,
                                              batch_axes, constrainer,
                                              make_rules, named_sharding)
from repro_torch.kernels.ops import resolve_device

from .attention import (AttnCfg, _out_proj, _proj, attn_apply, attn_decode,
                        attn_defs)
from .common import (ParamDef, attention, draw_param, flatten_defs, rms_norm,
                     specs)
from .mamba2 import MambaCfg, mamba_apply, mamba_decode, mamba_defs
from .mla import MLACfg, mla_apply, mla_decode, mla_defs
from .moe import MoECfg, mlp_apply, mlp_defs, moe_apply, moe_defs

__all__ = ["LM", "FAMILIES"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")


def _stack(defs, n: int):
    if isinstance(defs, ParamDef):
        return ParamDef((n, *defs.shape), ("layers", *defs.axes), defs.init,
                        defs.scale)
    return {k: _stack(v, n) for k, v in defs.items()}


def _n_stacked(d: ParamDef) -> int:
    """How many leading ``layers`` axes a leaf stacks."""
    n = 0
    while n < len(d.axes) and d.axes[n] == "layers":
        n += 1
    return n


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


def _map_leaves(tree: dict, fn) -> dict:
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _map_pair(tree: dict, other: dict, fn) -> dict:
    """``fn(leaf, other's leaf)`` over two trees of one structure."""
    return {k: _map_pair(v, other[k], fn) if isinstance(v, dict)
            else fn(v, other[k]) for k, v in tree.items()}


def _stack_outs(outs: list):
    """Per-layer cache outputs (nested tuples of tensors) → one nested
    tuple of tensors stacked on a new leading axis, as ``lax.scan``
    stacks its outputs."""
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(_stack_outs(list(t)) for t in zip(*outs))


def _node(v):
    """A parameter, or the module of a subtree (int keys: a stacked
    axis → ``ModuleList``)."""
    if isinstance(v, nn.Parameter):
        return v
    if all(isinstance(k, int) for k in v):
        return nn.ModuleList(_node(v[i]) for i in range(len(v)))
    return _Layer(v)


class _Layer(nn.Module):
    """One layer's parameters (or a superblock's, or the shared block's)
    under the JAX leaf names, nested as the JAX tree nests them: a
    tensor is a parameter, a subtree a child module; ``lp[name]`` reads
    either (``lp.attn["wq"]``, ``lp.moe["shared"]["w1"]``,
    ``bp["global"]``)."""

    def __init__(self, leaves: dict):
        super().__init__()
        for k, v in leaves.items():
            v = _node(v)
            if isinstance(v, nn.Parameter):
                self.register_parameter(k, v)
            else:
                self.add_module(k, v)

    def __getitem__(self, name: str):
        return getattr(self, name)


class LM(nn.Module):
    """An LM of any family at ``cfg``'s widths on ``device``
    (``None`` → cuda; raises where no GPU is visible), computing in
    ``dtype`` (the JAX ``compute_dtype``).  ``tp`` pads heads as the JAX
    ``LM`` does for a model axis of that size, so its parameter trees
    carry across.  ``mesh``: a
    :class:`~repro_torch.distributed.sharding.Mesh` to shard over (its
    first member is ``self.device``; ``device=`` is then ignored).
    ``trainable`` and ``remat``: see the module docstring."""

    def __init__(self, cfg: ModelConfig, *, tp: int = 1, device=None,
                 mesh=None, dtype=torch.bfloat16, trainable: bool = False,
                 remat: bool = True):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        self.cfg = cfg
        self.tp = tp
        self.mesh = mesh
        self.dtype = dtype
        self.trainable = trainable
        self.remat = remat
        self.device = mesh.devices[0] if mesh is not None else \
            resolve_device(device)
        self.rules = make_rules(mesh, cfg.rules_overrides)
        self._c = constrainer(mesh, self.rules)
        c = cfg
        if c.family in ("dense", "moe", "encdec"):
            if c.use_mla:
                self.mla_cfg = MLACfg(
                    c.d_model, c.n_heads, kv_lora=c.kv_lora, q_lora=c.q_lora,
                    rope_head_dim=c.rope_head_dim,
                    nope_head_dim=c.nope_head_dim, v_head_dim=c.v_head_dim,
                    rope_theta=c.rope_theta, tp=tp)
            else:
                self.attn_cfg = AttnCfg(
                    c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
                    qkv_bias=c.qkv_bias, rope_theta=c.rope_theta,
                    window=c.window, chunk=0, tp=tp)
                if c.chunk:   # llama4: local layers chunked, global NoPE
                    self.attn_local = self.attn_cfg._replace(chunk=c.chunk)
                    self.attn_global = self.attn_cfg._replace(use_rope=False)
        if c.n_experts:
            self.moe_cfg = MoECfg(
                c.d_model, c.n_experts, c.top_k, c.moe_d_ff,
                n_shared=c.n_shared_experts, shared_d_ff=c.shared_d_ff)
        if c.family in ("ssm", "hybrid"):
            self.mamba_cfg = MambaCfg(
                c.d_model, d_state=c.ssm_state, head_dim=c.ssm_head_dim,
                expand=c.ssm_expand, conv_kernel=c.conv_kernel,
                chunk=c.ssm_chunk, norm_eps=c.norm_eps)
        if c.family == "hybrid":
            self.attn_cfg = AttnCfg(
                c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
                rope_theta=c.rope_theta, tp=tp)
        # auto-demote rules whose dims cannot divide the model axis (as
        # the JAX ``_build``: e.g. 4 KV heads on a 16-way axis stay
        # replicated)
        tpn = max(1, tp)
        if hasattr(self, "attn_cfg") and self.attn_cfg.hkv % tpn:
            self.rules["kv_heads"] = None
            # decode runs sequence-parallel over the KV cache instead
            self.rules["kv_seq"] = "model" if mesh is not None else None
        else:
            self.rules["kv_seq"] = None
        if hasattr(self, "mamba_cfg"):
            m = self.mamba_cfg
            if any(d % tpn for d in (m.d_in_proj, m.conv_dim, m.d_inner)):
                self.rules["ssm_inner"] = None
            if m.n_heads % tpn:
                self.rules["ssm_heads"] = None
        self._spmd = None
        if mesh is None:
            self._allocate()
        else:
            self._allocate_sharded()

    # ------------------------------------------------------------ param defs
    def param_defs(self) -> dict:
        """The JAX ``LM.param_defs()`` tree: layers stacked on leading
        axes, as the JAX package stores them."""
        c = self.cfg
        e, vp = c.d_model, c.padded_vocab
        defs: dict[str, Any] = {
            "embed": ParamDef((vp, e), ("vocab", "embed"), scale=0.02),
            "final_norm": _norm_def(e),
        }
        if not c.tie_embeddings:
            defs["lm_head"] = ParamDef((e, vp), ("embed", "vocab"))

        def layer(attn, ffn, **extra):
            return {"ln1": _norm_def(e), "ln2": _norm_def(e), **extra,
                    "attn": attn, **ffn}

        if c.family == "dense":
            defs["layers"] = _stack(layer(attn_defs(self.attn_cfg),
                                          {"mlp": mlp_defs(e, c.d_ff)}),
                                    c.n_layers)
        elif c.family == "moe" and not c.use_mla:     # llama4 superblocks
            moe = {"moe": moe_defs(self.moe_cfg)}
            local = layer(attn_defs(self.attn_local), moe)
            glob = layer(attn_defs(self.attn_global), moe)
            defs["blocks"] = _stack({"local": _stack(local,
                                                     c.global_every - 1),
                                     "global": glob},
                                    c.n_layers // c.global_every)
        elif c.family == "moe":                       # deepseek (MLA)
            defs["first"] = layer(mla_defs(self.mla_cfg),
                                  {"mlp": mlp_defs(e, c.d_ff)})
            defs["layers"] = _stack(layer(mla_defs(self.mla_cfg),
                                          {"moe": moe_defs(self.moe_cfg)}),
                                    c.n_layers - c.first_dense)
        elif c.family == "ssm":
            defs["layers"] = _stack({"ln": _norm_def(e),
                                     "mamba": mamba_defs(self.mamba_cfg)},
                                    c.n_layers)
        elif c.family == "hybrid":
            mlayer = {"ln": _norm_def(e), "mamba": mamba_defs(self.mamba_cfg)}
            defs["blocks"] = _stack(_stack(mlayer, c.shared_attn_every),
                                    c.n_layers // c.shared_attn_every)
            defs["shared"] = layer(attn_defs(self.attn_cfg),
                                   {"mlp": mlp_defs(e, c.d_ff)})
        else:                                         # encdec
            mlp = {"mlp": mlp_defs(e, c.d_ff)}
            defs["encoder"] = _stack(layer(attn_defs(self.attn_cfg), mlp),
                                     c.n_enc_layers)
            defs["enc_norm"] = _norm_def(e)
            defs["layers"] = _stack(
                layer(attn_defs(self.attn_cfg), mlp, ln3=_norm_def(e),
                      xattn=attn_defs(self.attn_cfg)), c.n_layers)
        return defs

    @staticmethod
    def _module_path(path: tuple, idx: tuple) -> tuple:
        """Where the view of JAX leaf ``path`` at stacking index ``idx``
        sits in the module tree (ints index a ``ModuleList``)."""
        if path[:2] == ("blocks", "local"):     # llama4 (superblock, layer)
            return ("blocks", idx[0], "local", idx[1], *path[2:])
        return (path[0], *idx, *path[1:])

    def _allocate(self) -> None:
        """One tensor per JAX leaf (``self.params``), per-layer parameter
        views of it in the modules, and with ``trainable`` the gradient
        tree ``self.grads`` that the parameters' ``.grad`` view."""
        self.params: dict = {}
        self.grads: dict | None = {} if self.trainable else None
        self._views: dict = {}          # JAX leaf path → its parameters
        tree: dict = {}
        for path, d in flatten_defs(self.param_defs()):
            n_stack = _n_stacked(d)
            buf = torch.empty(d.shape, dtype=self._leaf_dtype(d),
                              device=self.device)
            grad = torch.zeros_like(buf) if self.trainable else None
            if n_stack == 0:
                buf = nn.Parameter(buf, requires_grad=self.trainable)
                buf.grad = grad
                views = [(path, buf)]
            else:
                views = []
                for idx in itertools.product(*map(range, d.shape[:n_stack])):
                    p = nn.Parameter(buf[idx], requires_grad=self.trainable)
                    if grad is not None:
                        p.grad = grad[idx]
                    views.append((self._module_path(path, idx), p))
            for where, p in views:
                _set(tree, where, p)
            self._views[path] = [p for _, p in views]
            _set(self.params, path, buf)
            if grad is not None:
                _set(self.grads, path, grad)
        for name, v in tree.items():
            v = _node(v)
            if isinstance(v, nn.Parameter):
                self.register_parameter(name, v)
            else:
                self.add_module(name, v)

    def _leaf_dtype(self, d: ParamDef):
        """float32 for a trainable LM and for vectors (norm weights, the
        mamba block's per-channel leaves), else the compute dtype."""
        vector = len(d.shape) - _n_stacked(d) <= 1
        return torch.float32 if self.trainable or vector else self.dtype

    def _allocate_sharded(self) -> None:
        """``self.params`` (and with ``trainable`` ``self.grads``) as
        :class:`ShardedTensor` leaves laid out by :meth:`param_shardings`,
        in the dtypes :meth:`_allocate` stores."""
        self.params: dict = {}
        self.grads: dict | None = {} if self.trainable else None
        shardings = self.param_shardings()
        for path, d in flatten_defs(self.param_defs()):
            dt = self._leaf_dtype(d)
            sh = _get(shardings, path)
            _set(self.params, path, ShardedTensor.empty(sh, d.shape, dt))
            if self.trainable:
                _set(self.grads, path, ShardedTensor.empty(
                    sh, d.shape, dt).map(torch.zero_))

    def param_specs(self):
        """The ``PartitionSpec`` tree of :meth:`param_defs` under
        ``self.rules`` (the JAX method's)."""
        return specs(self.param_defs(), self.rules)

    def param_shardings(self):
        """:meth:`param_specs` as :class:`NamedSharding` leaves over
        ``self.mesh`` (``None`` leaves without a mesh)."""
        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            return named_sharding(self.mesh, t)
        return walk(self.param_specs())

    def gather_params(self, device="cpu") -> dict:
        """The parameters in the JAX layout: ``self.params`` without a
        mesh, else every leaf gathered onto ``device``."""
        if self.mesh is None:
            return self.params
        return _map_leaves(self.params, lambda t: t.gather(device))

    def leaf_parameters(self, path: tuple) -> list[nn.Parameter]:
        """The parameters that view the JAX leaf at ``path``: one per
        stacked index, in stacking order."""
        return self._views[tuple(path)]

    @torch.no_grad()
    def load_leaf(self, path: tuple, value: torch.Tensor) -> None:
        """Copy one JAX-layout leaf (layer axes stacked) into
        ``self.params``, cast to its dtype and device."""
        _get(self.params, path).copy_(value)

    def init(self, generator: torch.Generator) -> "LM":
        """Seeded weights: each leaf of :meth:`param_defs` drawn whole in
        ``jax.tree.flatten`` order from ``generator`` (float32, on the
        generator's device, so a stacked leaf's float32 draw is a
        transient of its full size), then stored.  Returns ``self``."""
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
    def _attn(self, cfg, lp, x: torch.Tensor, kind: str = "causal"):
        """A layer's attention half over the whole sequence: ``x +
        attention(ln1(x))`` → (x', its cache: (k, v), or MLA's (c_kv,
        k_pe))."""
        h = rms_norm(x, lp.ln1, self.cfg.norm_eps)
        if isinstance(cfg, MLACfg):
            a, kv = mla_apply(cfg, lp.attn, h)
        else:
            a, kv = attn_apply(cfg, lp.attn, h, kind=kind)
        return x + a, kv

    def _attn_decode(self, cfg, lp, x: torch.Tensor, cache_a: torch.Tensor,
                     cache_b: torch.Tensor, pos: int) -> torch.Tensor:
        """A layer's attention half for one token (B, 1, E), its keys and
        values (MLA: latents) written into the layer's cache at ``pos``."""
        h = rms_norm(x, lp.ln1, self.cfg.norm_eps)
        fn = mla_decode if isinstance(cfg, MLACfg) else attn_decode
        a, _, _ = fn(cfg, lp.attn, h, cache_a, cache_b, pos)
        return x + a

    def _ffn(self, lp, x: torch.Tensor, ln: str = "ln2") -> torch.Tensor:
        """A layer's FFN half: ``x + ffn(norm(x))``, the routed experts
        where the layer has them, else the SwiGLU MLP."""
        h = rms_norm(x, lp[ln], self.cfg.norm_eps)
        if hasattr(lp, "moe"):
            return x + moe_apply(self.moe_cfg, lp.moe, h)
        return x + mlp_apply(lp.mlp, h)

    def _layer(self, lp, x: torch.Tensor, cfg=None, kind: str = "causal"):
        """One attention + FFN layer over the whole sequence (``cfg``:
        its attention config, default ``attn_cfg``) → (x', its cache)."""
        x, kv = self._attn(cfg or self.attn_cfg, lp, x, kind)
        return self._ffn(lp, x), kv

    def _decode_layer(self, lp, x: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, pos: int,
                      cfg=None) -> torch.Tensor:
        """One attention + FFN layer (or the shared block) for one token
        (B, 1, E), its keys and values written into the layer's cache
        (B, S_cache, hkv, D; MLA: the latent caches) at ``pos``."""
        x = self._attn_decode(cfg or self.attn_cfg, lp, x, cache_k, cache_v,
                              pos)
        return self._ffn(lp, x)

    def _mamba_layer(self, lp, x: torch.Tensor):
        """One mamba layer over the whole sequence → (x', (conv_state,
        ssm_state))."""
        y, st = mamba_apply(self.mamba_cfg, lp.mamba,
                            rms_norm(x, lp.ln, self.cfg.norm_eps))
        return x + y, st

    def _superblock(self, bp, x: torch.Tensor):
        """A hybrid superblock: its mamba layers, then the shared block
        → (x', ((conv, ssm) stacked over the layers, (k, v)))."""
        sts = []
        for lp in bp:
            x, st = self._mamba_layer(lp, x)
            sts.append(st)
        x, kv = self._layer(self.shared, x)
        return x, (_stack_outs(sts), kv)

    def _local_global(self, bp, x: torch.Tensor):
        """A llama4 superblock: its chunked-local layers, then the global
        NoPE layer → (x', ((k, v) stacked over the local layers, (k, v)
        of the global one))."""
        kvs = []
        for lp in bp.local:
            x, kv = self._layer(lp, x, self.attn_local)
            kvs.append(kv)
        x, gkv = self._layer(bp["global"], x, self.attn_global)
        return x, (_stack_outs(kvs), gkv)

    def _enc_layer(self, lp, x: torch.Tensor):
        """One encoder layer: bidirectional attention, then the MLP."""
        return self._layer(lp, x, kind="bidir")

    def _cross_attn(self, p, x: torch.Tensor, enc: torch.Tensor):
        """Cross-attention: queries from ``x``, keys and values from the
        encoder output; no RoPE, biases or head mask → (y, (k, v))."""
        k, v = _proj(enc, p["wk"]), _proj(enc, p["wv"])
        out = attention(_proj(x, p["wq"]), k, v, kind="bidir")
        return _out_proj(out, p["wo"]), (k, v)

    def _dec_layer(self, lp, x: torch.Tensor, enc: torch.Tensor):
        """One decoder layer over the whole sequence → (x', ((k, v),
        the cross-attention's (k, v)))."""
        eps = self.cfg.norm_eps
        x, kv = self._attn(self.attn_cfg, lp, x)
        xa, xkv = self._cross_attn(lp.xattn, rms_norm(x, lp.ln2, eps), enc)
        return self._ffn(lp, x + xa, "ln3"), (kv, xkv)

    def _dec_decode_layer(self, lp, x: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, xk: torch.Tensor,
                          xv: torch.Tensor, pos: int) -> torch.Tensor:
        """One decoder layer for one token: self-attention over the
        layer's cache (written at ``pos``), cross-attention over the
        cache's ``xk`` / ``xv`` (not written)."""
        x = self._attn_decode(self.attn_cfg, lp, x, cache_k, cache_v, pos)
        return self._ffn(lp, self._cross_decode(lp, x, xk, xv), "ln3")

    def _cross_decode(self, lp, x: torch.Tensor, xk: torch.Tensor,
                      xv: torch.Tensor) -> torch.Tensor:
        """A decoder layer's cross-attention half for one token: ``x +
        xattn(ln2(x))`` over the cached keys ``xk`` and values ``xv``."""
        h = rms_norm(x, lp.ln2, self.cfg.norm_eps)
        out = attention(_proj(h, lp.xattn["wq"]), xk, xv, kind="bidir")
        return x + _out_proj(out, lp.xattn["wo"])

    def _encode(self, frames: torch.Tensor, call=None) -> torch.Tensor:
        """The encoder over ``frames`` (B, S_enc, E), then ``enc_norm``."""
        call = call or (lambda fn, lp, x: fn(lp, x))
        enc = frames.to(self.dtype)
        for lp in self.encoder:
            enc, _ = call(self._enc_layer, lp, enc)
        return rms_norm(enc, self.enc_norm, self.cfg.norm_eps)

    def _forward(self, tokens: torch.Tensor, *, prefix=None, frames=None,
                 emit_cache: bool = False):
        """→ (hidden (B,S,E), cache-or-None). S includes any prefix.
        The cache is the JAX scan's output: dense ``(k, v)`` each
        (L, B, S, hkv, D); llama4 ``((k, v) each (nsb, nloc, B, S, hkv,
        D), (k, v) each (nsb, B, S, hkv, D))``; deepseek ``((c_kv, k_pe)
        of the first layer, (c_kv, k_pe) stacked over the others)``; ssm
        ``(conv, ssm)``; hybrid ``((conv, ssm) each (nsb, k, ...), (k, v)
        each (nsb, B, S, hkv, D))``; encdec ``((k, v), (xk, xv))`` each
        stacked over the decoder layers."""
        c = self.cfg
        x = self._embed(tokens)
        if prefix is not None:
            x = torch.cat([prefix.to(self.dtype), x], dim=1)
        remat = self.remat and self.trainable and torch.is_grad_enabled()

        def call(fn, lp, x):
            if remat:
                return checkpoint(fn, lp, x, use_reentrant=False)
            return fn(lp, x)

        first = None
        if c.family == "hybrid":
            body, stack = self._superblock, self.blocks
        elif c.family == "moe" and not c.use_mla:
            body, stack = self._local_global, self.blocks
        elif c.family == "moe":          # the dense first layer, unscanned
            x, first = self._layer(self.first, x, self.mla_cfg)
            body, stack = (lambda lp, x: self._layer(lp, x, self.mla_cfg),
                           self.layers)
        elif c.family == "ssm":
            body, stack = self._mamba_layer, self.layers
        elif c.family == "encdec":
            enc = self._encode(frames, call)
            body, stack = (lambda lp, x: self._dec_layer(lp, x, enc),
                           self.layers)
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
        cache = _stack_outs(outs)
        return x, (cache if first is None else (first, cache))

    # ------------------------------------------------------------------ loss
    def _inputs(self, batch: dict) -> dict:
        kw = {}
        if self.cfg.prefix_len:
            kw["prefix"] = batch["prefix"]
        if self.cfg.family == "encdec":
            kw["frames"] = batch["frames"]
        return kw

    def _mesh_exec(self):
        """The executor over ``self.mesh`` (built on first use)."""
        if self._spmd is None:
            from .sharded import LMMesh
            self._spmd = LMMesh(self)
        return self._spmd

    def reduce_grads(self) -> None:
        """On a mesh: sum each gradient leaf's copies held by members that
        share a slice, in member order, into every copy (the all-reduce
        GSPMD inserts for replicated parameters).  No-op without one."""
        if self.mesh is not None:
            self._mesh_exec().reduce_grads()

    def loss(self, batch: dict):
        """Next-token cross entropy over ``batch["tokens"]`` (B, S)
        against ``batch["targets"]`` (B, S) (plus ``batch["prefix"]``
        where the config has one, ``batch["frames"]`` for ``encdec``; the
        loss covers token positions only) → (loss, {"loss", "acc"}),
        float32 scalars.

        As the JAX function: the max through a stop-gradient, then
        log-sum-exp, then the one-hot contraction; ``acc`` uses argmax's
        first-index tie rule.  The padded vocabulary's ``-1e30`` columns
        get zero gradient."""
        c = self.cfg
        if self.mesh is not None:
            return self._mesh_exec().loss(batch)
        h, _ = self._forward(batch["tokens"], **self._inputs(batch))
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
        """``batch["tokens"]`` (B, S) (and ``batch["prefix"]`` (B, P, E)
        where the config has a prefix, ``batch["frames"]`` (B, S_enc, E)
        for ``encdec``) → (next token (B,) int32, the prefill cache of
        :meth:`_forward`; on a mesh, each cache leaf a ShardedTensor)."""
        if self.mesh is not None:
            return self._mesh_exec().prefill(batch)
        h, cache = self._forward(batch["tokens"], emit_cache=True,
                                 **self._inputs(batch))
        logits = self._logits(h[:, -1:])
        return argmax_tournament(logits[:, 0]), cache

    # ------------------------------------------------------------ decode API
    def init_cache(self, batch: int, cache_len: int, dtype=None) -> dict:
        """Zeroed decode cache, as the JAX ``init_cache``: dense
        ``{"k", "v"}`` each (L, B, len, hkv, D) (a sliding-window config
        keeps ``min(window, cache_len)`` slots); llama4 ``{"local":
        {"k", "v"} each (nsb, nloc, B, min(chunk, len), hkv, D),
        "global": {"k", "v"} each (nsb, B, len, hkv, D)}``; deepseek
        ``{"first": {"ckv" (B, len, kv_lora), "kpe" (B, len,
        rope_head_dim)}, "rest": the same with a leading n_layers − 1}``;
        ssm ``{"conv" (L, B, conv_dim, K−1), "ssm" (L, B, H, P, N)
        float32}``; hybrid the same with (nsb, k) leading axes plus
        ``"attn": {"k", "v"}`` each (nsb, B, len, hkv, D); encdec
        ``{"k", "v"}`` each (L, B, len, hkv, D) and ``"xk"``, ``"xv"``
        each (L, B, max(1, len // enc_len_ratio), hkv, D).

        On a mesh every leaf is a :class:`ShardedTensor` laid out by
        ``input_shardings`` (a length-sharded layout included)."""
        if self.mesh is None:
            return self._zero_cache(batch, cache_len, dtype, self.device)
        self._mesh_exec()
        shape = ShapeSpec("cache", cache_len, batch, "decode")
        like = self._zero_cache(batch, cache_len, dtype, "meta")
        return _map_pair(like, self.input_shardings(shape)["cache"],
                         lambda x, sh: ShardedTensor.empty(
                             sh, x.shape, x.dtype).map(torch.zero_))

    def _zero_cache(self, batch: int, cache_len: int, dtype,
                    device) -> dict:
        """:meth:`init_cache`'s global tree on ``device``."""
        c = self.cfg
        dt = dtype or self.dtype

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=device)

        def kv(lead, length):
            a = self.attn_cfg
            shape = (*lead, batch, length, a.hkv, a.head_dim)
            return {"k": zeros(*shape), "v": zeros(*shape)}

        if c.family == "dense":
            return kv((c.n_layers,),
                      min(c.window, cache_len) if c.window else cache_len)
        if c.family == "moe" and not c.use_mla:       # llama4
            nsb = c.n_layers // c.global_every
            return {"local": kv((nsb, c.global_every - 1),
                                min(c.chunk, cache_len)),
                    "global": kv((nsb,), cache_len)}
        if c.family == "moe":                          # deepseek MLA latent
            m = self.mla_cfg

            def latent(*lead):
                return {"ckv": zeros(*lead, batch, cache_len, m.kv_lora),
                        "kpe": zeros(*lead, batch, cache_len,
                                     m.rope_head_dim)}
            # ``rest`` holds n_layers − 1 layers, as the reference sizes it,
            # where the stack holds n_layers − first_dense (ROADMAP.md, R8)
            return {"first": latent(), "rest": latent(c.n_layers - 1)}
        if c.family == "encdec":
            out = kv((c.n_layers,), cache_len)
            xkv = kv((c.n_layers,), max(1, cache_len // c.enc_len_ratio))
            out["xk"], out["xv"] = xkv["k"], xkv["v"]
            return out
        m = self.mamba_cfg
        lead = (c.n_layers,) if c.family == "ssm" else \
            (c.n_layers // c.shared_attn_every, c.shared_attn_every)
        out = {"conv": zeros(*lead, batch, m.conv_dim, m.conv_kernel - 1),
               "ssm": zeros(*lead, batch, m.n_heads, m.head_dim, m.d_state,
                            dtype=torch.float32)}
        if c.family == "hybrid":
            out["attn"] = kv(lead[:1], cache_len)
        return out

    def _mamba_decode_layer(self, lp, x: torch.Tensor, conv: torch.Tensor,
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
        writes the step's keys, values, latents and states into
        ``cache``."""
        c = self.cfg
        pos = int(pos)
        x = self._embed(token)
        if c.family == "dense":
            for i, lp in enumerate(self.layers):
                x = self._decode_layer(lp, x, cache["k"][i], cache["v"][i],
                                       pos)
        elif c.family == "moe" and not c.use_mla:      # llama4
            loc, glo = cache["local"], cache["global"]
            for s, bp in enumerate(self.blocks):
                for j, lp in enumerate(bp.local):
                    x = self._decode_layer(lp, x, loc["k"][s, j],
                                           loc["v"][s, j], pos,
                                           self.attn_local)
                x = self._decode_layer(bp["global"], x, glo["k"][s],
                                       glo["v"][s], pos, self.attn_global)
        elif c.family == "moe":                        # deepseek
            first, rest = cache["first"], cache["rest"]
            x = self._decode_layer(self.first, x, first["ckv"], first["kpe"],
                                   pos, self.mla_cfg)
            for i, lp in enumerate(self.layers):
                x = self._decode_layer(lp, x, rest["ckv"][i],
                                       rest["kpe"][i], pos, self.mla_cfg)
        elif c.family == "ssm":
            for i, lp in enumerate(self.layers):
                x = self._mamba_decode_layer(lp, x, cache["conv"][i],
                                             cache["ssm"][i])
        elif c.family == "hybrid":
            for s, bp in enumerate(self.blocks):
                for j, lp in enumerate(bp):
                    x = self._mamba_decode_layer(lp, x, cache["conv"][s, j],
                                                 cache["ssm"][s, j])
                x = self._decode_layer(self.shared, x, cache["attn"]["k"][s],
                                       cache["attn"]["v"][s], pos)
        else:                                          # encdec
            for i, lp in enumerate(self.layers):
                x = self._dec_decode_layer(lp, x, cache["k"][i],
                                           cache["v"][i], cache["xk"][i],
                                           cache["xv"][i], pos)
        return rms_norm(x, self.final_norm, c.norm_eps)

    def decode_step(self, cache: dict, token: torch.Tensor, pos):
        """token (B,1) int, pos an int → (next_token (B,) int32, cache).

        The cache is updated in place and returned (the JAX method
        returns a new one)."""
        if self.mesh is not None:
            return self._mesh_exec().decode_step(cache, token, pos)
        x = self._decode_hidden(cache, token, pos)
        logits = self._logits(x)
        return argmax_tournament(logits[:, 0]), cache    # no softmax (paper)

    # ---------------------------------------------------------- dry-run I/O
    def input_specs(self, shape: ShapeSpec) -> dict:
        """Meta-device stand-ins (shape and dtype, no allocation) for every
        model input of ``shape``, as the JAX ``ShapeDtypeStruct``s: train
        ``tokens`` / ``targets`` (and ``prefix`` / ``frames``), prefill
        ``tokens`` (and ``prefix`` / ``frames``), decode ``token`` (B, 1),
        ``pos`` () and the global ``cache`` tree."""
        c = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def sd(*shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device="meta")
        if shape.kind in ("train", "prefill"):
            out = {"tokens": sd(b, s)}
            if shape.kind == "train":
                out["targets"] = sd(b, s)
            if c.prefix_len:
                out["prefix"] = sd(b, c.prefix_len, c.d_model,
                                   dtype=self.dtype)
            if c.family == "encdec":
                out["frames"] = sd(b, s // c.enc_len_ratio, c.d_model,
                                   dtype=self.dtype)
            return out
        # decode: one new token against a cache of length seq_len
        return {"token": sd(b, 1), "pos": sd(),
                "cache": self._zero_cache(b, s, None, "meta")}

    def input_shardings(self, shape: ShapeSpec):
        """:class:`NamedSharding` trees matching :meth:`input_specs`
        (``None`` without a mesh), by the JAX method's rules: the batch
        over the data extent where it divides; a decode cache's heads over
        ``model`` where they divide, else its length (1,024 or more) over
        ``model``, and over the data axes too where the batch cannot be
        sharded; never ``head_dim``."""
        if self.mesh is None:
            return None
        c = self.cfg
        mesh = self.mesh
        bspec = batch_axes(self.rules, shape.global_batch, mesh)

        def ns(*axes):
            return named_sharding(mesh, axes)

        if shape.kind in ("train", "prefill"):
            out = {"tokens": ns(bspec, None)}
            if shape.kind == "train":
                out["targets"] = ns(bspec, None)
            if c.prefix_len:
                out["prefix"] = ns(bspec, None, None)
            if c.family == "encdec":
                out["frames"] = ns(bspec, None, None)
            return out

        cache = self._zero_cache(shape.global_batch, shape.seq_len, None,
                                 "meta")
        return {"token": ns(bspec, None), "pos": ns(),
                "cache": _map_leaves(cache, lambda x: self.cache_sharding(
                    x.shape, shape.global_batch))}

    def cache_sharding(self, shp, global_batch: int,
                       bdim: int | None = None) -> NamedSharding:
        """The JAX ``kv_spec`` rule for one cache leaf of shape ``shp``
        (layout ``(..layer dims.., B, S, [H, D])``): batch over the data
        extent when it divides; heads over ``model`` when they divide
        (keeps attention local); else the length (1,024 or more) over
        ``model``; a batch that cannot be sharded puts the length over
        the data axes too.  Never ``head_dim``: RoPE halves it.

        The batch dimension is the first one equal to ``global_batch``,
        as JAX's ``shp.index`` takes it (a stacking axis of that size
        comes first, and the rule then shards it), unless ``bdim`` names
        it: the mesh executor's working layout."""
        mesh = self.mesh
        bspec = batch_axes(self.rules, global_batch, mesh)
        tpn = mesh.shape.get("model", 1)
        dp = self.rules.get("batch")
        dp_names = (dp,) if isinstance(dp, str) else tuple(dp or ())
        dpn = 1
        for nme in dp_names:
            dpn *= mesh.shape[nme]
        shp = tuple(shp)
        nd = len(shp)
        spec = [None] * nd
        if bdim is None:
            try:
                bdim = shp.index(global_batch)
            except ValueError:
                return named_sharding(mesh, spec)
        if bspec is not None:
            spec[bdim] = bspec
        sdim = bdim + 1 if nd > bdim + 1 else None
        hdim = bdim + 2 if nd >= bdim + 4 else None
        if hdim is not None and shp[hdim] % tpn == 0:
            spec[hdim] = "model"
        elif sdim is not None and shp[sdim] >= 1024 and shp[sdim] % tpn == 0:
            spec[sdim] = "model"
        if bspec is None and sdim is not None and shp[sdim] >= 1024 and \
                shp[sdim] % dpn == 0 and spec[sdim] is None and \
                dp is not None:
            spec[sdim] = dp
        return named_sharding(mesh, spec)
