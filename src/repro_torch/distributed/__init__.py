"""Sharding rules and activation constraints, as spec arithmetic over
device-less meshes (``launch.mesh``): the port runs on one card."""

from repro_torch.distributed.sharding import (  # noqa: F401
    cache_specs,
    choose_spec,
    data_axes,
    input_specs_shardings,
    opt_state_specs,
    param_specs,
    shard_bytes,
    shard_shape,
)
