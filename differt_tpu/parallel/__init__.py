"""Multi-device / multi-host scaling via ``jax.sharding``.

The reference is strictly single-device (SURVEY.md section 2); this module
is the scaling layer: scene geometry is replicated in every device's
memory, while the embarrassingly-parallel axes — RX grid points, TX
positions, and path candidates — are sharded across a device mesh. All
compute inside the solvers is batched elementwise over those axes, so XLA
partitions the jitted computation with zero communication on the forward
pass; gradients of replicated parameters (materials, geometry) are
all-reduced automatically by XLA during the backward pass.
"""

from ._sharding import (
    make_device_mesh,
    placement_training_step,
    replicate,
    shard_along,
    sharded_power_map,
    sharded_trace_paths,
    streamed_placement_loss,
    streamed_placement_step,
    training_step,
)

__all__ = [
    "make_device_mesh",
    "placement_training_step",
    "replicate",
    "shard_along",
    "sharded_power_map",
    "sharded_trace_paths",
    "streamed_placement_loss",
    "streamed_placement_step",
    "training_step",
]
