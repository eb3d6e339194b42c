"""The process layer (``torch.distributed``) and the training meters."""

from .mesh import (
    allgather_object,
    initialize_distributed,
    is_primary,
    local_device,
    make_mesh,
    replicate,
    shard_along,
)
from .meters import MetricLogger, SmoothedValue

__all__ = [
    "make_mesh",
    "shard_along",
    "replicate",
    "initialize_distributed",
    "is_primary",
    "local_device",
    "allgather_object",
    "SmoothedValue",
    "MetricLogger",
]
