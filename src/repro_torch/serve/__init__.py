from repro_torch.serve.engine import ServeConfig, Server
from repro_torch.serve.fleet import FleetColdStart, FleetConfig, ServeFleet
from repro_torch.serve.stream import (
    ChunkCache,
    LayerGroup,
    StreamedRestore,
    plan_layer_groups,
    stream_restore,
)

__all__ = [
    "ChunkCache",
    "FleetColdStart",
    "FleetConfig",
    "LayerGroup",
    "ServeConfig",
    "ServeFleet",
    "Server",
    "StreamedRestore",
    "plan_layer_groups",
    "stream_restore",
]
