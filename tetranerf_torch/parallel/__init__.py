"""Training over ranks: data shards and feature-field shards
(:mod:`.distributed`)."""

from .distributed import (
    GatherColumns,
    Group,
    check_model_shards,
    column_slice,
    destroy,
    gather_columns,
    host_batch_slice,
    init_distributed,
    table_checksum,
)

__all__ = ["GatherColumns", "Group", "check_model_shards", "column_slice", "destroy",
           "gather_columns", "host_batch_slice", "init_distributed", "table_checksum"]
