"""The 1-D data mesh every TM data-parallel path runs over (port of the TM
half of ``repro.distributed.sharding``).

The JAX package's mesh paths are single-controller: one process runs
``shard_map`` over its local devices.  The port keeps that shape.  A
:class:`Mesh` is a frozen, hashable tuple of ``torch.device`` objects with
named axes; a data-parallel path launches each shard's work on its
shard's device from the one process, and moves data between shards with
explicit ``.to(device)`` copies where JAX has ``all_gather`` /
``psum_scatter``.

A mesh may list one device several times — ``devices=[torch.device(
"cpu")] * 8`` or ``[cuda:0] * 4`` — and its shards then run one after
another on that device: the port's counterpart of
``--xla_force_host_platform_device_count``, and how the CPU tests and a
one-card machine get D > 1.  The code path is the same for a simulated
mesh and a real one: ``.to(owner)`` is a no-op where the devices match.

The LM half: :func:`make_rules` maps the model zoo's logical axes
(``batch``, ``embed``, ``heads``, ...) onto a ``("data", "model")`` or
``("pod", "data", "model")`` mesh, :func:`batch_axes` and
:func:`constrainer` resolve them for a given shape (a dimension that
does not divide its mesh extent stays unsharded, as in JAX), and
:class:`NamedSharding` is the port's ``(mesh, spec)`` pair with
``shard_shape`` and each member's slice.  A :class:`ShardedTensor` holds
one tensor per mesh member, the slice its sharding gives that member,
on that member's device: repeated members hold separate tensors, so
what a member holds is its shard.  JAX's ``constrainer`` returns the
array under a ``with_sharding_constraint``; the port's returns the
resolved :class:`NamedSharding`, since the port moves data itself.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["DATA_AXIS", "Mesh", "data_mesh", "visible_devices",
           "resolve_mesh", "mesh_device", "PartitionSpec", "NamedSharding",
           "ShardedTensor", "leaf_parts", "make_rules", "batch_axes",
           "named_sharding", "constrainer"]

# the one mesh axis name the TM data-parallel paths shard over
DATA_AXIS = "data"


def _norm(device) -> torch.device:
    """``device`` as a ``torch.device`` with a cuda index filled in, so
    ``"cuda"`` and ``"cuda:0"`` name one mesh member."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and \
            torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named-axis grid of ``torch.device`` objects (hashable, as JAX's
    ``Mesh`` is, so engines cache by it).

    ``devices`` is the flat, row-major tuple of members (repeats allowed:
    a simulated mesh); ``axis_names`` names the axes and ``dims`` gives
    their sizes (default: one axis over every device).  The TM paths
    accept only 1-D meshes.
    """

    devices: tuple
    axis_names: tuple = (DATA_AXIS,)
    dims: tuple | None = None

    def __post_init__(self):
        devs = tuple(_norm(d) for d in self.devices)
        names = tuple(self.axis_names)
        dims = (len(devs),) if self.dims is None else \
            tuple(int(n) for n in self.dims)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(dims) != len(names) or math.prod(dims) != len(devs):
            raise ValueError(f"mesh axes {names} of sizes {dims} do not "
                             f"hold {len(devs)} device(s)")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "dims", dims)

    @property
    def shape(self) -> dict:
        """``{axis name: size}``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        """Number of shards (members, repeats counted)."""
        return len(self.devices)

    def distinct_devices(self) -> tuple:
        """The members without repeats, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    def coords(self, member: int) -> dict:
        """``{axis name: index}`` of flat member ``member`` (row-major)."""
        out, rest = {}, member
        for name, n in reversed(list(zip(self.axis_names, self.dims))):
            out[name] = rest % n
            rest //= n
        return {n: out[n] for n in self.axis_names}


def visible_devices() -> list[torch.device]:
    """Every CUDA device torch sees, in index order (none on a CPU-only
    host)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def data_mesh(n_devices: int | None = None, *, devices=None) -> Mesh:
    """A 1-D ``("data",)`` mesh over the first ``n_devices`` of
    ``devices`` (default: every visible CUDA device).

    ``n_devices=None`` takes them all.  A count larger than what is
    there raises ``ValueError``: elastic callers (``TMServer.restore``)
    clamp before calling, because TM training is mesh-size invariant.
    ``devices=`` simulates a larger mesh by listing one device several
    times.
    """
    devs = [_norm(d) for d in devices] if devices is not None else \
        visible_devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"data_mesh({n_devices}) but only {len(devs)} device(s) "
                f"visible; pass n_devices<={len(devs)} or simulate more "
                f"with devices=[device] * n")
        devs = devs[:n_devices]
    if not devs:
        raise RuntimeError(
            "data_mesh: no CUDA device visible; pass devices= (e.g. "
            "[torch.device('cpu')] * n) to build a mesh on the CPU")
    return Mesh(tuple(devs), (DATA_AXIS,))


def resolve_mesh(mesh) -> Mesh | None:
    """A server's ``mesh=`` argument → a 1-D :class:`Mesh` or ``None``:
    a mesh passes through (a 2-D one raises), a device count builds
    :func:`data_mesh` over that many visible devices."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        mesh = data_mesh(int(mesh))
    if len(mesh.axis_names) != 1:
        raise ValueError(f"TMServer needs a 1-D mesh, got {mesh.axis_names}")
    return mesh


def mesh_device(mesh: Mesh, device=None) -> torch.device:
    """The device a mesh-configured server holds its state on: the mesh's
    first device.  A ``device=`` that is not a member raises."""
    if device is not None and _norm(device) not in mesh.devices:
        raise ValueError(f"device {str(device)!r} is not in the mesh "
                         f"{[str(d) for d in mesh.distinct_devices()]}")
    return mesh.devices[0]


# -- the LM zoo's logical-axis sharding ----------------------------------


def _names(entry) -> tuple:
    """A spec entry (``None``, an axis name or a tuple of them) → the
    tuple of mesh axis names it shards over."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _extent(mesh: Mesh, entry) -> int:
    return math.prod(mesh.shape[n] for n in _names(entry))


class PartitionSpec(tuple):
    """A tuple of per-dimension entries — ``None``, a mesh axis name or a
    tuple of names — as ``jax.sharding.PartitionSpec(*entries)``; a
    one-name tuple is stored as the name, as JAX stores it."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else (e or None)
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``spec`` over ``mesh`` (``jax.sharding.NamedSharding``'s
    counterpart): dimension ``i`` of an array is split over the mesh
    axes ``spec[i]`` names, in their order; dimensions past the spec and
    mesh axes it does not name are replicated."""

    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        spec = PartitionSpec(*self.spec)
        used = [n for e in spec for n in _names(e)]
        unknown = [n for n in used if n not in self.mesh.axis_names]
        if unknown or len(used) != len(set(used)):
            raise ValueError(f"spec {spec} does not fit the mesh axes "
                             f"{self.mesh.axis_names}")
        object.__setattr__(self, "spec", spec)

    def shard_shape(self, global_shape) -> tuple:
        """Each member's shape; raises ``ValueError`` where a sharded
        dimension does not divide its mesh extent (as JAX does)."""
        shape = tuple(int(n) for n in global_shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"shape {shape} has dimensions")
        out = list(shape)
        for i, e in enumerate(self.spec):
            k = _extent(self.mesh, e)
            if shape[i] % k:
                raise ValueError(f"dimension {i} of {shape} does not split "
                                 f"{k} ways under {self.spec}")
            out[i] = shape[i] // k
        return tuple(out)

    def member_index(self, member: int, global_shape) -> tuple:
        """The slices of a ``global_shape`` array that ``member`` holds."""
        local = self.shard_shape(global_shape)
        co = self.mesh.coords(member)
        idx = []
        for i, n in enumerate(local):
            block = 0
            for name in _names(self.spec[i] if i < len(self.spec) else None):
                block = block * self.mesh.shape[name] + co[name]
            idx.append(slice(block * n, (block + 1) * n))
        return tuple(idx)

    def block(self, member: int) -> tuple:
        """The member's block coordinates, one per sharded dimension:
        members with equal blocks hold the same slice."""
        co = self.mesh.coords(member)
        return tuple(tuple(co[n] for n in _names(e)) for e in self.spec)


class ShardedTensor:
    """A global array held as one tensor per member of ``sharding.mesh``:
    ``shards[k]`` is the :meth:`NamedSharding.member_index` slice of
    member ``k``, on member ``k``'s device.  A leaf of a sharded ``LM``'s
    ``params`` / ``grads`` and of the optimizer moments."""

    def __init__(self, sharding: NamedSharding, shape, shards):
        self.sharding = sharding
        self.shape = tuple(int(n) for n in shape)
        self.shards = list(shards)
        if len(self.shards) != sharding.mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of "
                             f"{sharding.mesh.size} members")

    @classmethod
    def empty(cls, sharding: NamedSharding, shape, dtype) -> "ShardedTensor":
        local = sharding.shard_shape(shape)
        return cls(sharding, shape, [torch.empty(local, dtype=dtype,
                                                 device=d)
                                     for d in sharding.mesh.devices])

    @classmethod
    def from_full(cls, full, sharding: NamedSharding,
                  dtype=None) -> "ShardedTensor":
        """``full`` (a tensor or array of the global shape) sliced for
        every member, each slice copied onto its member's device."""
        full = torch.as_tensor(full)
        dtype = dtype or full.dtype
        out = []
        for k, dev in enumerate(sharding.mesh.devices):
            part = full[sharding.member_index(k, full.shape)]
            out.append(part.to(device=dev, dtype=dtype, copy=True))
        return cls(sharding, full.shape, out)

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        return self.shards[0].device

    def distinct(self) -> list:
        """``[(member, shard)]`` of the first member holding each slice,
        in member order (a replicated slice counted once)."""
        seen, out = set(), []
        for k, t in enumerate(self.shards):
            b = self.sharding.block(k)
            if b not in seen:
                seen.add(b)
                out.append((k, t))
        return out

    def gather(self, device="cpu") -> torch.Tensor:
        """The global array on ``device``: every distinct shard copied
        (``.to``, bitwise) into its slice."""
        first = self.shards[0]
        full = torch.empty(self.shape, dtype=first.dtype, device=device)
        with torch.no_grad():
            for k, t in self.distinct():
                full[self.sharding.member_index(k, self.shape)] = \
                    t.detach().to(device)
        return full

    def map(self, fn) -> "ShardedTensor":
        """``fn`` applied to every shard → a ShardedTensor of the same
        sharding and shape (``fn`` keeps each shard's shape)."""
        return ShardedTensor(self.sharding, self.shape,
                             [fn(t) for t in self.shards])

    @torch.no_grad()
    def copy_(self, src) -> "ShardedTensor":
        """Copy ``src`` in: another ShardedTensor of the same sharding
        (shard by shard), or a global tensor or array (sliced)."""
        if isinstance(src, ShardedTensor):
            for dst, s in zip(self.shards, src.shards):
                if s is not dst:
                    dst.copy_(s)
            return self
        full = torch.as_tensor(src)
        if tuple(full.shape) != self.shape:
            raise ValueError(f"cannot copy a {tuple(full.shape)} array into "
                             f"a sharded {self.shape} leaf")
        for k, dst in enumerate(self.shards):
            dst.copy_(full[self.sharding.member_index(k, self.shape)])
        return self

    def nbytes(self, member: int = 0) -> int:
        t = self.shards[member]
        return t.numel() * t.element_size()

    def __repr__(self) -> str:
        return (f"ShardedTensor({self.shape}, {self.dtype}, "
                f"{self.sharding.spec}, {self.sharding.mesh.dims})")


def leaf_parts(x) -> list:
    """A tree leaf's tensors: every shard of a :class:`ShardedTensor`,
    else the leaf itself."""
    return x.shards if isinstance(x, ShardedTensor) else [x]


def make_rules(mesh: Mesh | None, overrides: tuple[tuple[str, Any], ...] = ()
               ) -> dict[str, Any]:
    """Default logical→mesh mapping for a ('pod'?, 'data', 'model') mesh."""
    axes = mesh.axis_names if mesh is not None else ()
    dp = tuple(a for a in ("pod", "data") if a in axes) or None
    if dp and len(dp) == 1:
        dp = dp[0]
    model = "model" if "model" in axes else None
    data = "data" if "data" in axes else None
    rules: dict[str, Any] = {
        "batch": dp,
        "embed": data,        # FSDP
        "vocab": model,
        "heads": model,
        "kv_heads": model,
        "mlp": model,
        "experts": model,
        "expert_mlp": None,   # expert FF dim: EP only (no nested TP)
        "ssm_inner": model,
        "ssm_heads": model,
        "layers": None,
        "seq": data,          # long-context KV cache seq sharding
        "act_seq": None,      # Megatron-SP residual-stream seq sharding
        "conv": None,
        # flattened token-dispatch dim (MoE): sharded over every axis
        "tokens": tuple(a for a in ("pod", "data", "model") if a in axes)
        or None,
    }
    rules.update(dict(overrides))
    return rules


def batch_axes(rules: dict, batch: int, mesh: Mesh | None):
    """Batch-dim sharding if the global batch divides the dp extent."""
    dp = rules.get("batch")
    if mesh is None or dp is None:
        return None
    return dp if batch % _extent(mesh, dp) == 0 else None


def named_sharding(mesh: Mesh | None, spec) -> NamedSharding | None:
    if mesh is None:
        return None
    return NamedSharding(mesh, PartitionSpec(*spec))


def constrainer(mesh: Mesh | None, rules: dict):
    """Return ``c(x, *logical_axes)`` → the :class:`NamedSharding` an
    array of ``x``'s shape takes under ``rules`` (``None`` without a
    mesh).  A logical axis may be a str (looked up in rules), None, or a
    raw tuple of mesh axis names; a dimension that does not divide its
    mesh extent, or that ``x`` lacks, stays unsharded."""
    if mesh is None:
        return lambda x, *axes: None

    def c(x, *axes):
        resolved = []
        for i, a in enumerate(axes):
            if a is None:
                r = None
            elif isinstance(a, str):
                r = rules.get(a)
            else:
                r = a
            if r is not None and (i >= len(x.shape)
                                  or x.shape[i] % _extent(mesh, r)):
                r = None        # non-dividing dims stay unconstrained
            resolved.append(r)
        return NamedSharding(mesh, PartitionSpec(*resolved))

    return c
