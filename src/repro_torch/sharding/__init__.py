"""repro_torch.sharding — spreading work over devices.

`rules.make_channel_fanout` splits an independent-channel stream
processor over a list of devices (the port's counterpart of the JAX
package's `shard_map` channel fan-out); `collectives` holds the mesh
axis that per-shard code gathers and permutes over (`DeviceAxis`,
`GroupAxis`, `TraceAxis`), and `pipeline` the GPipe stage loop.
"""
from repro_torch.sharding.collectives import DeviceAxis, GroupAxis, TraceAxis
from repro_torch.sharding.pipeline import make_pipelined, pipeline_forward
from repro_torch.sharding.rules import group_size, make_channel_fanout

__all__ = ["DeviceAxis", "GroupAxis", "TraceAxis", "group_size",
           "make_channel_fanout", "make_pipelined", "pipeline_forward"]
