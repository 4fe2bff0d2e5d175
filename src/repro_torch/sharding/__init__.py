"""repro_torch.sharding — spreading the engine's work over devices.

`rules.make_channel_fanout` splits an independent-channel stream
processor over a list of devices (the port's counterpart of the JAX
package's `shard_map` channel fan-out).
"""
from repro_torch.sharding.rules import group_size, make_channel_fanout

__all__ = ["group_size", "make_channel_fanout"]
