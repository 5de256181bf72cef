"""Multi-device execution (port of ``repro.distributed``): the 1-D data
mesh of the TM data-parallel paths, and fault tolerance for training
(:mod:`.fault_tolerance`).  The LM zoo's sharding rules come with the
sharding slice (ROADMAP.md, queue 1, item 7f)."""

from .sharding import (DATA_AXIS, Mesh, data_mesh, mesh_device,
                       resolve_mesh, visible_devices)

__all__ = ["DATA_AXIS", "Mesh", "data_mesh", "mesh_device", "resolve_mesh",
           "visible_devices"]
