"""Indexes beyond the graph: persistence (the same on-disk format as the
JAX package), the host tier, the IVF index and the streaming tier."""

from diskrag_tpu_torch.index.persist import (
    IndexStore,
    load_index,
    read_compat_records,
    save_index,
    write_compat_records,
)
from diskrag_tpu_torch.index.streaming import StreamingIndex

__all__ = [
    "IndexStore",
    "save_index",
    "load_index",
    "write_compat_records",
    "read_compat_records",
    "StreamingIndex",
]
