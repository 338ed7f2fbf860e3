"""Data-parallel serving over the local cards — the port's counterpart of
imageprocessor_tpu/parallel.

The workload is embarrassingly parallel over images, so one worker
process can drive several local cards: the engine keeps one replica per
card (a card, a stream and a host thread), and each packed group runs
whole on the next free replica (runtime/engine.py). A group's bytes are
the ones a single card gives, since nothing of it is split or padded
for the replicas. The reference splits every group's batch across its
chips instead.

Cross-host distribution stays on the queue (one consumer-group member per
host), as in the reference. The reference's second, ``space`` axis (image
width sharded across chips) is not served: a group of WORKER_BATCH_SIZE
32 at the largest bucket fits one H100, and column strips over two cards
made a 12 MP group's device stage slower, not faster (README.md).
"""

from imageprocessor_tpu_torch.parallel.mesh import make_devices, replica_devices

__all__ = ["make_devices", "replica_devices"]
