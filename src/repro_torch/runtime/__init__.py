"""repro_torch.runtime: the elastic runtime.

Ported from ``repro.runtime``: checkpoint/restart (``checkpoint``), mesh
re-selection, heartbeats and state placement (``elastic``), straggler
detection and the row rebalance (``straggler``), and the controller that
turns device-set changes and stragglers into re-planning through the shared
plan cache, with its resize, rebalance and refit records (``controller``).
"""
from .checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from .controller import (
    ElasticController,
    RebalanceEvent,
    RefitEvent,
    ResizeEvent,
    cache_delta_event,
)
from .elastic import (
    HeartbeatMonitor,
    MeshRequirements,
    choose_mesh_shape,
    make_mesh_from_devices,
    reshard_state,
)
from .straggler import StragglerConfig, StragglerDetector, rebalance_shards

__all__ = [
    "CheckpointManager", "latest_step", "restore_checkpoint",
    "save_checkpoint",
    "HeartbeatMonitor", "MeshRequirements", "choose_mesh_shape",
    "make_mesh_from_devices", "reshard_state",
    "StragglerConfig", "StragglerDetector", "rebalance_shards",
    "ElasticController", "RebalanceEvent", "ResizeEvent",
    "cache_delta_event", "RefitEvent",
]
