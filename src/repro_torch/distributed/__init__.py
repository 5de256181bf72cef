"""Multi-device execution (port of ``repro.distributed``): the 1-D data
mesh of the TM data-parallel paths.  The LM zoo's sharding rules and
fault tolerance come with the model zoo (see ROADMAP.md)."""

from .sharding import (DATA_AXIS, Mesh, data_mesh, mesh_device,
                       resolve_mesh, visible_devices)

__all__ = ["DATA_AXIS", "Mesh", "data_mesh", "mesh_device", "resolve_mesh",
           "visible_devices"]
