"""Data-parallel training over ranks (:mod:`.distributed`)."""

from .distributed import (
    Group,
    destroy,
    host_batch_slice,
    init_distributed,
    table_checksum,
)

__all__ = ["Group", "destroy", "host_batch_slice", "init_distributed", "table_checksum"]
