"""Scale-out: one process over several devices (a list of
torch.devices) and several processes over node-range shards
(torch.distributed)."""

from .multihost import MultihostGraphDecoder, init_distributed
from .sharded import ShardedGraphDecoder, make_devices

__all__ = ["MultihostGraphDecoder", "ShardedGraphDecoder",
           "init_distributed", "make_devices"]
