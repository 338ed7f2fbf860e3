"""Message broker for the port: the in-process MemoryBroker.

Copies of the reference's jax-free broker modules (see each file's note);
the reference's SQLite and Kafka backends are not ported yet.
"""

from imageprocessor_tpu_torch.broker.base import Broker, BrokerMessage
from imageprocessor_tpu_torch.broker.memory import MemoryBroker

__all__ = ["Broker", "BrokerMessage", "MemoryBroker"]
