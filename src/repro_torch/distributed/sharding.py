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

``make_rules`` / ``named_sharding`` / ``constrainer`` / ``batch_axes``
(the LM zoo's logical-axis sharding) come with the model zoo (see
ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["DATA_AXIS", "Mesh", "data_mesh", "visible_devices",
           "resolve_mesh", "mesh_device"]

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
