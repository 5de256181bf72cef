"""Multi-device execution (port of ``repro.distributed``): the 1-D data
mesh of the TM data-parallel paths, and fault tolerance for training
(:mod:`.fault_tolerance`), and the LM zoo's logical-axis sharding
over a ``("data", "model")`` or ``("pod", "data", "model")`` mesh."""

from .sharding import (DATA_AXIS, Mesh, NamedSharding, PartitionSpec,
                       ShardedTensor, batch_axes, constrainer, data_mesh,
                       make_rules, mesh_device, named_sharding, resolve_mesh,
                       visible_devices)

__all__ = ["DATA_AXIS", "Mesh", "NamedSharding", "PartitionSpec",
           "ShardedTensor", "batch_axes", "constrainer", "data_mesh",
           "make_rules", "mesh_device", "named_sharding", "resolve_mesh",
           "visible_devices"]
