"""Multi-pod dry-run (port of ``repro.launch.dryrun``): every (arch ×
shape × mesh) cell on the meta device, at full size, nothing allocated.

For each cell this proves, without hardware:

- the sharding is coherent: every parameter's, cache's and input's shard
  shape (``NamedSharding.shard_shape`` raises where a sharded dimension
  does not divide its extent; the rules fall back as JAX's do);
- the step's per-device memory in the port's own storage dtypes
  (float32 masters, gradients and AdamW moments for ``train``; bfloat16
  matrices and float32 vectors for serving), against the card's 80 GiB;
- the roofline terms under :data:`~repro_torch.roofline.analysis.H100`:
  FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` over a meta run
  of the step at full depth (forward, plus backward for ``train``)
  divided by the mesh size; the bytes the step must read and write; and
  the bytes the port's own mesh moves (:mod:`repro_torch.models.sharded`:
  the FSDP gathers, the partial sums, a MoE layer's token gather,
  dispatch and combine, a mamba layer's ``in_proj`` block exchange,
  per-channel leaves, norm statistics and ``out_proj`` rows, a
  length-sharded cache's softmax partials, and the regather of a cache
  stored under a stacking-axis spec).

API differences from the JAX dry-run, which compiles each cell for 512
fake devices and reads XLA's analyses: no ``compile_s``, ``temp_GiB``,
``alias_GiB`` or ``hlo_collective_counts`` (there is no compiler, and no
HLO to parse); FLOPs count matrix products only (``FlopCounterMode``),
where XLA counts every operation; a MoE layer's products are counted
from their fixed ``(E, cap, d)`` shapes, since routing's ``bincount`` /
``index_put_`` have no meta kernel (the cell says so).  Every cell,
multi-pod ones too (whose FLOPs and roofline are left out, as in JAX)
and those run with ``--no-roofline``, carries the collective bytes of
the port's mesh: every family serves and trains there.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch tinyllama-1.1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single \\
        --no-roofline
Results accumulate in ``results/dryrun_torch.json`` (incremental; safe to
re-run).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import traceback

import torch

__all__ = ["ARCHS", "cells", "run_cell", "make_lm", "member_bytes",
           "length_sharded", "main"]

ARCHS = [
    "llama4-scout-17b-a16e", "deepseek-v2-236b", "zamba2-2.7b",
    "seamless-m4t-large-v2", "internvl2-26b", "qwen1.5-110b",
    "starcoder2-7b", "qwen1.5-4b", "tinyllama-1.1b", "mamba2-130m",
]

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch.json")

GIB = 2 ** 30
CARD_GIB = 80.0
META = torch.device("meta")


def cells():
    from repro_torch.configs import SHAPES, get_config
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape_name in SHAPES:
            if shape_name == "long_500k" and not cfg.supports_long:
                continue
            yield arch, shape_name


def meta_mesh(multi_pod: bool):
    from repro_torch.launch.mesh import make_production_mesh
    return make_production_mesh(multi_pod=multi_pod,
                                devices=[META] * (512 if multi_pod else 256))


def make_lm(cfg, shape, mesh):
    """The cell's LM on ``mesh``, with the JAX dry-run's production rules:
    Megatron-SP residual ``act_seq`` over ``model`` for attention-family
    train steps without chunked attention, else the MoE ``tokens``
    dispatch over the batch axes only."""
    from repro_torch.models.model import LM
    lm = LM(cfg, tp=mesh.shape["model"], mesh=mesh, dtype=torch.bfloat16,
            trainable=shape.kind == "train", remat=shape.kind == "train")
    if shape.kind == "train" and cfg.family in ("dense", "moe", "encdec") \
            and not cfg.chunk:
        lm.rules["act_seq"] = "model"
    else:
        lm.rules["tokens"] = lm.rules.get("batch")
    return lm


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def member_bytes(lm, shape) -> dict:
    """Bytes member 0 holds for one step of ``shape`` (every member holds
    the same shard shapes), by part: ``params``; for ``train`` ``opt``
    (AdamW's float32 moments and int32 count) and ``grads`` (the float32
    gradient tree a trainable ``LM`` holds); ``inputs`` (the decode cache
    among them; not ``pos``, a host int in the port); ``outputs`` (train: the four float32 metrics, the state
    is updated in place; prefill: the next token and the prefill cache;
    decode: the next token, the cache is written in place); plus the
    ``shard_shapes`` of every leaf, input and output."""
    shapes = {}
    params = 0
    for path, st in _walk(lm.params):
        local = st.sharding.shard_shape(st.shape)
        shapes["params/" + "/".join(path)] = list(local)
        params += _nbytes(local, st.dtype)
    specs, shards = lm.input_specs(shape), lm.input_shardings(shape)
    inputs = 0
    for path, x in _walk(specs):
        local = _walk_get(shards, path).shard_shape(x.shape)
        shapes["inputs/" + "/".join(path)] = list(local)
        if path != ("pos",):    # the port's decode_step takes a host int
            inputs += _nbytes(local, x.dtype)
    b = shape.global_batch
    b_local = _local_batch(lm, shape)
    out = {"params": params, "inputs": inputs}
    if shape.kind == "train":
        out["opt"] = 2 * params + 4
        out["grads"] = params
        out["outputs"] = 4 * 4
    elif shape.kind == "prefill":
        outputs = b_local * 4
        for i, x in enumerate(_prefill_cache(lm, shape)):
            local = lm.cache_sharding(x.shape, b).shard_shape(x.shape)
            shapes[f"outputs/cache/{i}"] = list(local)
            outputs += _nbytes(local, x.dtype)
        out["outputs"] = outputs
    else:
        out["outputs"] = b_local * 4
    out["shard_shapes"] = shapes
    return out


def _local_batch(lm, shape) -> int:
    """Rows of the global batch one member holds."""
    name = "token" if shape.kind == "decode" else "tokens"
    return lm.input_shardings(shape)[name].shard_shape(
        (shape.global_batch, 1))[0]


def _walk_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _prefill_cache(lm, shape) -> list:
    """The prefill cache's global leaves (meta tensors), from a meta run
    of the unsharded model."""
    ref = _meta_lm(lm.cfg, lm.tp, shape)
    with _moe_on_meta():
        _, cache = ref.prefill(ref.input_specs(shape))
    from repro_torch.tree import leaves
    return leaves(cache)


def _meta_lm(cfg, tp, shape):
    from repro_torch.models.model import LM
    return LM(cfg, tp=tp, device=META, dtype=torch.bfloat16,
              trainable=shape.kind == "train", remat=shape.kind == "train")


def _moe_meta(c, p, x):
    """``moe_apply``'s products at its shapes, for a meta run: the router
    (T, d) @ (d, E), the three expert products over the (E, cap, d)
    buffer and the shared experts; the routing itself (no meta kernel
    for ``bincount`` / ``index_put_``) is left out."""
    from repro_torch.models.moe import mlp_apply
    b, s, e = x.shape
    t, dt = b * s, x.dtype
    xt = x.reshape(t, e)
    logits = xt @ p["router"].to(dt)
    cap = int(max(1, c.capacity_factor * t * c.top_k / c.n_experts))
    buf = xt.reshape(-1)[:1].reshape(1, 1, 1).expand(c.n_experts, cap, e)
    h = torch.nn.functional.silu(torch.bmm(buf, p["w1"].to(dt))) * \
        torch.bmm(buf, p["w3"].to(dt))
    out = torch.bmm(h, p["w2"].to(dt)).reshape(-1, e)[:t]
    yt = out * logits[:, :1].to(dt)
    if c.n_shared:
        yt = yt + mlp_apply(p["shared"], xt)
    return yt.reshape(b, s, e)


@contextlib.contextmanager
def _moe_on_meta():
    from repro_torch.models import model
    real = model.moe_apply
    model.moe_apply = _moe_meta
    try:
        yield
    finally:
        model.moe_apply = real


def step_flops(cfg, shape, tp: int) -> float:
    """FLOPs of one step of the unsharded model at full size, counted by
    ``FlopCounterMode`` over a meta run (train: loss and backward with
    remat, as the JAX dry-run lowers it)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.common import unroll_scans
    lm = _meta_lm(cfg, tp, shape)
    batch = lm.input_specs(shape)
    with unroll_scans(), _moe_on_meta(), \
            FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            loss, _ = lm.loss(batch)
            loss.backward()
        elif shape.kind == "prefill":
            lm.prefill(batch)
        else:
            lm.decode_step(batch["cache"], batch["token"], shape.seq_len - 1)
    return float(fc.get_total_flops())


def step_bytes(lm, shape, mem: dict) -> float:
    """Bytes member 0 must read and write in one step: ``train`` reads
    and writes its parameters, gradients and both moments once each
    (8 × the float32 parameter shards) and reads its inputs; ``prefill``
    reads its parameters and inputs and writes its outputs; ``decode``
    reads its parameters (of an untied embedding only the batch's rows),
    every cache slot (the cache is full at ``pos = S − 1``), writes one
    slot per attention cache, reads and writes the mamba states, reads
    the cross-attention cache, and reads and writes the token.
    Activations are not counted."""
    if shape.kind == "train":
        return 8.0 * mem["params"] + mem["inputs"]
    if shape.kind == "prefill":
        return float(mem["params"] + mem["inputs"] + mem["outputs"])
    total = 0.0
    for path, st in _walk(lm.params):
        local = st.sharding.shard_shape(st.shape)
        if path == ("embed",) and not lm.cfg.tie_embeddings:
            b_local = mem["shard_shapes"]["inputs/token"][0]
            local = (min(b_local, local[0]), local[1])
        total += _nbytes(local, st.dtype)
    specs = lm.input_specs(shape)
    for path, x in _walk(specs["cache"]):
        local = mem["shard_shapes"]["inputs/cache/" + "/".join(path)]
        nb = _nbytes(local, x.dtype)
        name = path[-1]
        if name in ("conv", "ssm"):
            total += 2 * nb
        elif name in ("xk", "xv"):
            total += nb
        else:
            bdim = list(x.shape).index(shape.global_batch)
            total += nb + nb / local[bdim + 1]
    return total + 2 * mem["outputs"]


def length_sharded(lm, shape, leaf: str = "k") -> list:
    """The decode cell's attention units whose cache the mesh executor
    runs sequence-parallel → ``[(unit, the mesh axes that split the
    length)]``: the working layout (``cache_sharding`` with the batch at
    its true position) shards the cache length.  ``leaf="xk"``: the
    decoder layers' cross-attention caches instead."""
    from repro_torch.models.sharded import units
    if shape.kind != "decode":
        return []
    cache = lm.input_specs(shape)["cache"]
    out = []
    for u in units(lm):
        if u.kind not in (("dec",) if leaf == "xk" else ("attn", "dec")):
            continue
        name = "ckv" if lm.cfg.use_mla else leaf
        x = _walk_get(cache, u.site + (name,))
        sh = lm.cache_sharding(x.shape, shape.global_batch,
                               bdim=len(u.cidx))
        axes = _axis_names(sh.spec[len(u.cidx) + 1])
        if math.prod(lm.mesh.shape[n] for n in axes) > 1:
            out.append((u, axes))
    return out


def _regather_bytes(lm, shape) -> float:
    """A decode step's bytes into member 0 for the cache leaves stored
    under a spec other than the executor's working one (the JAX rule's
    ``shp.index`` can shard a stacking axis): the leaf gathered onto
    member 0, then (unless read-only) the working copy gathered back."""
    from repro_torch.models.sharded import READ_ONLY, _cache_names, units
    if shape.kind != "decode":
        return 0.0
    cache = lm.input_specs(shape)["cache"]
    b, seen, total = shape.global_batch, set(), 0.0
    for u in units(lm):
        for name in _cache_names(u):
            path = u.site + (name,)
            if path in seen:
                continue
            seen.add(path)
            x = _walk_get(cache, path)
            stored = lm.cache_sharding(x.shape, b)
            work = lm.cache_sharding(x.shape, b, bdim=len(u.cidx))
            if tuple(stored.spec) == tuple(work.spec):
                continue
            full = _nbytes(x.shape, x.dtype)
            total += full - _nbytes(stored.shard_shape(x.shape), x.dtype)
            if name not in READ_ONLY:
                total += full - _nbytes(work.shard_shape(x.shape), x.dtype)
    return total


def _extent(lm, entry) -> int:
    return math.prod(lm.mesh.shape[n] for n in _axis_names(entry))


def _mamba_bytes(lm, u, shape, b_local: int, s: int, elt: int) -> float:
    """A mamba layer's bytes into member 0 (``models.sharded``'s
    ``_mamba``): the other column blocks of ``in_proj``'s product, the
    per-channel leaves gathered whole, the norm's float32 sums of
    squares from its ``P`` group, the channels of its ``out_proj`` rows
    held by the other ``P`` slices, the row blocks' partial outputs,
    and in decode the other blocks of the conv outputs."""
    m = lm.mamba_cfg
    path = u.prefix + ("mamba",)
    leaf = _walk_get(lm.params, path + ("in_proj",))
    g_in = _extent(lm, leaf.sharding.spec[len(u.idx) + 1])
    rows = b_local * s
    out = (g_in - 1) * rows * (m.d_in_proj // g_in) * elt
    for name in ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm_w"):
        st = _walk_get(lm.params, path + (name,))
        local = st.sharding.shard_shape(st.shape)[len(u.idx):]
        g = math.prod(_extent(lm, e) for e in st.sharding.spec)
        out += (g - 1) * _nbytes(local, st.dtype)
    # the states' working layout: the SSM state's P (B, H, P, N) and the
    # conv state's channels (B, C, K−1), each the next-to-last dimension
    like = lm._zero_cache(shape.global_batch, 1, None, META)
    g_p, g_c = (_extent(lm, lm.cache_sharding(
        x.shape, shape.global_batch, bdim=x.dim() - nd).spec[x.dim() - 2])
        for x, nd in ((like["ssm"], 4), (like["conv"], 3)))
    g_o = _extent(lm, _walk_get(lm.params, path + ("out_proj",))
                  .sharding.spec[len(u.idx)])
    if g_p > 1:
        out += (g_p - 1) * rows * 4
        out += (g_p - 1) * rows * (m.d_inner // g_o // g_p) * elt
    out += (g_o - 1) * rows * m.d_model * elt
    if shape.kind == "decode":
        out += (g_c - 1) * rows * (m.conv_dim // g_c) * elt
    return out


def _axis_names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _moe_bytes(lm, shape, b_local: int, s: int, elt: int) -> float:
    """A MoE layer's bytes into member 0: the other row groups' token
    rows gathered for routing, their dispatch buffers of member 0's
    ``E/tp`` experts (each owner sends the whole masked ``(E/tp, cap,
    d)`` buffer), and the combine's finished sum from the last model
    member."""
    c, mesh = lm.cfg, lm.mesh
    tpn = mesh.shape.get("model", 1)
    groups = shape.global_batch // b_local
    t = shape.global_batch * s
    cap = int(max(1, lm.moe_cfg.capacity_factor * t * c.top_k
                  / c.n_experts))
    rows = b_local * s * c.d_model * elt
    return (groups - 1) * (rows + c.n_experts // tpn * cap * c.d_model
                           * elt) + (rows if tpn > 1 else 0)


def _softmax_bytes(lm, u, axes: tuple, b_local: int, elt: int) -> float:
    """A length-sharded attention unit's bytes into member 0 from the
    other members of its length group (split over ``axes``): their
    maxima and sums (float32), their ``w·v`` partials, and (where the
    group is the model group, whose members hold different query heads)
    their queries."""
    from repro_torch.models.mla import MLACfg
    a, mesh = u.attn, lm.mesh
    mla = isinstance(a, MLACfg)
    width = a.kv_lora if mla else a.head_dim
    qw = a.kv_lora + a.rope_head_dim if mla else a.head_dim
    g = math.prod(mesh.shape[n] for n in axes)
    own = a.hq // mesh.shape.get("model", 1)
    union = a.hq if "model" in axes else own
    return (g - 1) * b_local * (2 * union * 4 + union * width * elt
                                + (union - own) * qw * elt)


def _unit_bytes(lm, u, shape, b_local: int, s: int, elt: int) -> float:
    """One unit's bytes into member 0: the other ``model`` members'
    partial outputs of its attention, cross-attention and FFN halves (a
    MoE layer's shared experts, plus :func:`_moe_bytes`), or a mamba
    layer's (:func:`_mamba_bytes`).  An encoder layer runs over the
    frames' ``s // enc_len_ratio`` positions."""
    c = lm.cfg
    tpn = lm.mesh.shape.get("model", 1)
    if u.kind == "mamba":
        return _mamba_bytes(lm, u, shape, b_local, s, elt)
    s_u = s // c.enc_len_ratio if u.kind == "enc" else s
    halves = 3 if u.kind == "dec" else 2
    out = halves * (tpn - 1) * b_local * s_u * c.d_model * elt
    if u.ffn == "moe":
        out += _moe_bytes(lm, shape, b_local, s, elt)
    return out


def collective_bytes(lm, shape) -> float:
    """Bytes member 0 receives in one step over the port's mesh: every
    FSDP gather (the
    other members' shards of each leaf split over a non-model axis, for
    each unit that uses it: zamba2's shared block once a superblock, the
    encoder not in decode), the embedding rows' and token picks' partials,
    each unit's partial sums and exchanges (:func:`_unit_bytes`), a
    length-sharded cache's softmax partials (:func:`_softmax_bytes`,
    self- and cross-attention), a stacking-axis cache's regather
    (:func:`_regather_bytes`), and for ``train`` the gathers and sums
    once more for the remat recompute and once more in the backward
    pass (every unit runs under a remat checkpoint, and each exchange's
    backward moves what its forward moved: a gather's is the
    reduce-scatter of the gradient, a partial sum's a sum, a MoE
    layer's dispatch and combine run back), plus the summing of
    replicated gradient slices."""
    from repro_torch.models.sharded import units
    c, mesh = lm.cfg, lm.mesh
    tpn = mesh.shape.get("model", 1)
    decode = shape.kind == "decode"
    uses = {"shared": c.n_layers // c.shared_attn_every
            if c.family == "hybrid" else 1,
            "encoder": 0 if decode else 1}
    gather = sync = 0.0
    for path, st in _walk(lm.params):
        sh = st.sharding
        local = sh.shard_shape(st.shape)
        nb = _nbytes(local, st.dtype)
        others = [n for e in sh.spec for n in _axis_names(e)
                  if n != "model"]
        gather += nb * (math.prod(mesh.shape[n] for n in others) - 1) \
            * uses.get(path[0], 1)
        copies = mesh.size // math.prod(
            mesh.shape[n] for e in sh.spec for n in _axis_names(e))
        sync += nb * (copies - 1)
    b_local = _local_batch(lm, shape)
    s = 1 if decode else shape.seq_len + c.prefix_len
    elt = torch.empty((), dtype=lm.dtype).element_size()
    picks = b_local * (shape.seq_len if shape.kind == "train" else 1) * 8
    psum = (tpn - 1) * (b_local * s * c.d_model * elt + picks)
    for u in units(lm):
        if not (decode and u.kind == "enc"):
            psum += _unit_bytes(lm, u, shape, b_local, s, elt)
    for leaf in ("k", "xk"):
        for u, axes in length_sharded(lm, shape, leaf):
            psum += _softmax_bytes(lm, u, axes, b_local, elt)
    psum += _regather_bytes(lm, shape)
    if shape.kind == "train":
        psum += (tpn - 1) * 2 * b_local * shape.seq_len * 4
        return 3 * (gather + psum) + sync
    return gather + psum


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             roofline: bool = True, *, cfg=None, shape=None,
             mesh=None) -> dict:
    """One cell's record (``cfg`` / ``shape`` / ``mesh`` override the
    registry's, for tests and reduced cells); without ``roofline`` its
    ``per_device`` holds the collective bytes alone."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.roofline.analysis import H100, model_flops, \
        roofline_terms
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or meta_mesh(multi_pod)
    n_dev = mesh.size
    out: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "multi" if multi_pod else "single",
                 "mesh_shape": dict(mesh.shape), "n_devices": n_dev}
    lm = make_lm(cfg, shape, mesh)
    mem = member_bytes(lm, shape)
    out["shard_shapes"] = mem["shard_shapes"]
    arg = mem["params"] + mem["inputs"] + mem.get("opt", 0)
    total = arg + mem["outputs"] + mem.get("grads", 0)
    parts = {k: v for k, v in mem.items() if k != "shard_shapes"}
    out["memory"] = {
        "argument_GiB": arg / GIB, "output_GiB": mem["outputs"] / GIB,
        **({"grads_GiB": mem["grads"] / GIB} if "grads" in mem else {}),
        "total_GiB": total / GIB, "fits_80GiB": total / GIB <= CARD_GIB,
        "bytes": {**parts, "argument": arg, "total": total}}
    coll = collective_bytes(lm, shape)
    if not roofline:
        out["per_device"] = {"collective_bytes": coll}
        return out
    flops = step_flops(cfg, shape, lm.tp) / n_dev
    bytes_ = step_bytes(lm, shape, mem)
    out["per_device"] = {"flops": flops, "bytes": bytes_,
                         "collective_bytes": coll}
    if cfg.n_experts:
        out["flops_note"] = ("moe_apply's products counted from their "
                             "(E, cap, d) shapes: routing has no meta "
                             "kernel (bincount, index_put_)")
    mf = model_flops(cfg, shape)
    terms = roofline_terms(flops, bytes_, coll, H100)
    out["roofline"] = {**terms, "hw": dataclasses.asdict(H100),
                       "model_flops_global": mf,
                       "model_flops_per_dev": mf / n_dev,
                       "useful_flops_ratio": (mf / n_dev) / flops
                       if flops else 0.0}
    return out


def load_results(path: str = RESULTS) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def save_results(res: dict, path: str = RESULTS):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1, sort_keys=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS,
                    help="results file (default results/dryrun_torch.json)")
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("name --arch / --shape, or pass --all")

    todo = []
    for arch, shape in cells():
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape != args.shape:
            continue
        for mp in ((False, True) if args.mesh == "both" else
                   ((args.mesh == "multi"),)):
            todo.append((arch, shape, mp))

    results = load_results(args.out)
    failures = 0
    for arch, shape, mp in todo:
        key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
        if key in results and not args.force and \
                "error" not in results[key]:
            print(f"[skip] {key}")
            continue
        print(f"[run ] {key} ...", flush=True)
        try:
            # the roofline is single-pod only, as in JAX; multi proves the
            # pod axis
            res = run_cell(arch, shape, mp,
                           roofline=(not args.no_roofline) and not mp)
            results[key] = res
            msg = f"  ok mem/dev={res['memory']['total_GiB']:.2f}GiB"
            if "roofline" in res:
                r = res["roofline"]
                msg += (f" bottleneck={r['bottleneck']}"
                        f" frac={r['roofline_fraction']:.3f}")
            print(msg, flush=True)
        except Exception as e:  # noqa: BLE001 - a cell's failure is its record
            failures += 1
            results[key] = {"arch": arch, "shape": shape,
                            "mesh": "multi" if mp else "single",
                            "error": f"{type(e).__name__}: {e}",
                            "trace": traceback.format_exc()[-2000:]}
            print(f"  FAIL {type(e).__name__}: {str(e)[:200]}", flush=True)
        save_results(results, args.out)
    print(f"done: {len(todo)} cells, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
