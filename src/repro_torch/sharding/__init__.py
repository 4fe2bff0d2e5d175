"""repro_torch.sharding — spreading work over devices.

`rules` holds the sharding rules of the model side (a spec for every
parameter, batch and cache, `placements` for DTensor) and
`make_channel_fanout`, which splits an independent-channel stream
processor over a list of devices (the port's counterpart of the JAX
package's `shard_map` channel fan-out); `hints` the activation hints
(`maybe_shard`) and the DTensor helpers of the model code;
`collectives` the mesh axis that per-shard code gathers and permutes
over (`DeviceAxis`, `GroupAxis`, `TraceAxis`), and `pipeline` the GPipe
stage loop.
"""
from repro_torch.sharding.collectives import DeviceAxis, GroupAxis, TraceAxis
from repro_torch.sharding.pipeline import make_pipelined, pipeline_forward
from repro_torch.sharding.rules import (batch_spec, cache_spec, dp_axes,
                                        group_size, make_channel_fanout,
                                        param_spec, params_shardings,
                                        placements, state_cache_shardings)

__all__ = ["DeviceAxis", "GroupAxis", "TraceAxis", "batch_spec",
           "cache_spec", "dp_axes", "group_size", "make_channel_fanout",
           "make_pipelined", "param_spec", "params_shardings",
           "pipeline_forward",
           "placements", "state_cache_shardings"]
