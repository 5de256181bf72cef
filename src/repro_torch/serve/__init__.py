"""Serving layer: the TM micro-batching scheduler (port of
``repro.serve``: predict and online-learning planes) and its traffic
generators.

See ``python -m repro_torch.launch.tm_serve``.  ``TMFleet`` and the LM
decode path come in later slices of the port (see ROADMAP.md).
"""

from .loadgen import (DeadlineExceeded, closed_loop, open_loop,
                      percentiles_ms)
from .tm_server import (ServePolicy, TMServer, bucket_for, default_buckets,
                        route_buckets)

__all__ = ["DeadlineExceeded", "ServePolicy", "TMServer", "bucket_for",
           "closed_loop", "default_buckets", "open_loop", "percentiles_ms",
           "route_buckets"]
