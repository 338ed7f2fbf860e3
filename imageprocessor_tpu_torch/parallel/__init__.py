"""Multi-card serving over the local cards — the port's counterpart of
imageprocessor_tpu/parallel.

One worker process can drive several local cards, in the reference's
(data x space) grid:

* the data axis: the engine keeps d replicas (each its cards, a stream
  per card and a host thread), and each packed group runs whole on the
  next free replica (runtime/engine.py). The reference splits every
  group's batch across its chips instead;
* the space axis: a replica is s cards, and each group it runs is split
  into s column strips of its bucket (16-aligned, with a 16-column halo
  each side), strip k on card k. Kernels B1-B4 launch once per strip, on
  the strip's own operands (models/strips.py). The reference shards
  width with GSPMD and turns its Pallas kernels off under that axis.

A group's bytes are the ones a single card gives, whichever replica
runs it and however many strips it has. Cross-host distribution stays on
the queue (one consumer-group member per host), as in the reference.
"""

from imageprocessor_tpu_torch.parallel.mesh import (
    HALO,
    STRIP_ALIGN,
    make_devices,
    owned_ranges,
    replica_devices,
    strip_bounds,
    strip_halos,
)

__all__ = ["HALO", "STRIP_ALIGN", "make_devices", "owned_ranges",
           "replica_devices", "strip_bounds", "strip_halos"]
