"""Production mesh factory (port of ``repro.launch.mesh``).

Single pod: ``(data=16, model=16)`` = 256 members; multi-pod adds a
leading pure-DP ``pod`` axis: ``(pod=2, data=16, model=16)`` = 512.
A member is a ``torch.device``: the visible GPUs by default, one device
listed several times (``[cuda:0] * 4``: a simulated mesh whose members
run one after another), or ``torch.device("meta")`` for the dry-run,
which allocates nothing.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import Mesh, visible_devices

__all__ = ["make_production_mesh", "mesh_from_devices", "mesh_from_flag"]


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) with a
    ``pod`` axis, over ``devices`` (default: the visible GPUs; a
    ``ValueError`` unless there are that many)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for d in shape:
        n *= d
    devs = list(devices) if devices is not None else visible_devices()
    if len(devs) < n:
        raise ValueError(f"the {'multi' if multi_pod else 'single'}-pod mesh "
                         f"{shape} needs {n} devices, {len(devs)} visible; "
                         f"pass devices= (e.g. [torch.device('meta')] * {n} "
                         f"for a dry-run)")
    return Mesh(tuple(devs[:n]), axes, shape)


def mesh_from_devices(devices, *, model: int = 16) -> Mesh:
    """Elastic re-mesh: the largest (data, model) mesh from a live device
    list (``fault_tolerance.ElasticRunner``'s hook), the JAX arithmetic:
    ``model = min(model, n)``, ``data = n // model``."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    model = min(model, n)
    data = n // model
    return Mesh(tuple(devices[: data * model]), ("data", "model"),
                (data, model))


def mesh_from_flag(flag, device) -> Mesh | None:
    """A launcher's ``--mesh`` → a mesh (``None`` passes through, as does
    a :class:`Mesh`): ``host<N>`` is :func:`mesh_from_devices` over N
    members with ``model = min(2, N)``, as the JAX launchers build it —
    the first N visible GPUs when ``device`` is cuda and that many are
    visible, else ``device`` listed N times (a simulated mesh);
    ``single`` / ``multi`` is :func:`make_production_mesh` over the
    visible GPUs (a ``ValueError`` unless there are 256 / 512)."""
    if flag is None or isinstance(flag, Mesh):
        return flag
    device = torch.device(device)
    if flag in ("single", "multi"):
        return make_production_mesh(multi_pod=flag == "multi")
    if not (flag.startswith("host") and flag[4:].isdigit() and
            int(flag[4:]) > 0):
        raise ValueError(f"--mesh {flag!r}: expected host<N>, single or "
                         f"multi")
    n = int(flag[4:])
    gpus = visible_devices()
    devs = gpus[:n] if device.type == "cuda" and device.index in (None, 0) \
        and len(gpus) >= n else [device] * n
    return mesh_from_devices(devs, model=min(2, n))
