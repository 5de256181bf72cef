"""Serving layer: the TM micro-batching scheduler (port of
``repro.serve``: predict, online-learning, lifecycle and shed-tier
planes), the multi-tenant fleet over it and their traffic generators.

See ``python -m repro_torch.launch.tm_serve``.  The LM zoo's greedy
decode loop is :func:`repro_torch.serve.decode.generate` (``python -m
repro_torch.launch.serve``).
"""

from .loadgen import (DeadlineExceeded, closed_loop, open_loop,
                      percentiles_ms)
from .tm_fleet import TMFleet, fuse_states, pack_key
from .tm_server import (ServePolicy, TMServer, bucket_for, default_buckets,
                        route_buckets)

__all__ = ["DeadlineExceeded", "ServePolicy", "TMFleet", "TMServer",
           "bucket_for", "closed_loop", "default_buckets", "fuse_states",
           "open_loop", "pack_key", "percentiles_ms", "route_buckets"]
