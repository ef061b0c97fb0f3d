"""Mesh construction and per-shard placement (counterpart of
`diskrag_tpu/parallel/mesh.py`).

A `Mesh` is a ("data", "shard") grid of torch devices: shard `j` of data
row `i` lives on `grid[i][j]`. A list of devices may name one device more
than once, which is how one card (or the CPU, in the tests) hosts several
shards. A mesh built by `parallel.multihost.global_shard_mesh` spans several
processes: `grid` holds this process's devices and `shape["shard"]` counts
the shards of every process.

`place` splits a stacked [S, ...] array over a mesh into `PlacedShards`:
one tensor per shard and device, shared by the data rows that sit on the
same device (a `.to(device)` of a tensor already there is no copy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A [n_data][n_local_shards] grid of devices. `n_processes` > 1 when
    the mesh spans processes (each holds its own `grid`, and its shards
    come after those of lower ranks in the global shard order)."""

    grid: tuple[tuple[torch.device, ...], ...]
    n_processes: int = 1
    process_index: int = 0

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.grid), "shard": len(self.grid[0]) * self.n_processes}

    @property
    def local_shards(self) -> int:
        return len(self.grid[0])

    @property
    def first_device(self) -> torch.device:
        return self.grid[0][0]


def make_mesh(n_shards: int | None = None, n_data: int = 1, devices: list | None = None) -> Mesh:
    """A ("data", "shard") mesh. With `n_shards` None the shard axis takes
    every device the data axis leaves. `devices` defaults to every visible
    card; each entry is resolved as an entry point's `device` is (a "cuda"
    device raises without a card)."""
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(n_cards)] or ["cuda"]
    devs = [resolve_device(d) for d in devices]
    n = len(devs)
    if n_shards is None:
        if n % n_data:
            raise ValueError(f"{n} devices not divisible by n_data={n_data}")
        n_shards = n // n_data
    use = n_data * n_shards
    if use > n:
        raise ValueError(f"need {use} devices, have {n}")
    grid = tuple(tuple(devs[i * n_shards : (i + 1) * n_shards]) for i in range(n_data))
    return Mesh(grid)


@dataclasses.dataclass(frozen=True)
class PlacedShards:
    """A stacked [S, ...] array split over a mesh: `blocks[i][j]` is shard
    j's slice on the device of data row i."""

    blocks: tuple[tuple[torch.Tensor, ...], ...]

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self.blocks[0]),) + tuple(self.blocks[0][0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0][0].dtype

    def shard(self, j: int) -> torch.Tensor:
        """Shard j as data row 0 holds it."""
        return self.blocks[0][j]

    def numpy(self) -> np.ndarray:
        """The stacked array on the host (bf16 as float32)."""
        out = [b.cpu() for b in self.blocks[0]]
        if out[0].dtype == torch.bfloat16:
            out = [b.to(torch.float32) for b in out]
        return np.stack([b.numpy() for b in out])

    def nbytes_by_device(self) -> dict[str, int]:
        """Bytes held on each device (one copy per shard and device)."""
        seen: dict[tuple[int, str], int] = {}
        for row in self.blocks:
            for j, b in enumerate(row):
                seen[(j, str(b.device))] = int(b.numel() * b.element_size())
        out: dict[str, int] = {}
        for (_, dev), nb in seen.items():
            out[dev] = out.get(dev, 0) + nb
        return out


def _host_block(a: np.ndarray, dtype: torch.dtype | None) -> torch.Tensor:
    """One shard of a host array as a host tensor; a cast (f32 -> bf16) is
    made in chunks of rows, so a memory-mapped shard is never copied whole
    in f32."""
    if dtype is None or a.ndim == 0:
        t = torch.from_numpy(np.array(a))
        return t if dtype is None else t.to(dtype)
    out = torch.empty(a.shape, dtype=dtype)
    step = 262_144
    for i in range(0, a.shape[0], step):
        out[i : i + step] = torch.from_numpy(np.array(a[i : i + step]))
    return out


def place(array, mesh: Mesh, dtype: torch.dtype | None = None) -> PlacedShards:
    """Split a stacked [S, ...] array (numpy, possibly memory-mapped, or a
    tensor) over `mesh`'s local shards, cast to `dtype` when given. An
    already placed array is re-cast block by block."""
    if isinstance(array, PlacedShards):
        where = tuple(tuple(b.device for b in row) for row in array.blocks)
        if where != mesh.grid:  # placed on another mesh: through the host
            array = torch.stack([b.cpu() for b in array.blocks[0]])
        elif dtype is None or array.dtype == dtype:
            return array
        else:
            return PlacedShards(tuple(tuple(b.to(dtype) for b in row) for row in array.blocks))
    if array.shape[0] != mesh.local_shards:
        raise ValueError(f"{array.shape[0]} shards for a mesh with {mesh.local_shards} "
                         "shard slots in this process")
    cache: dict[tuple[int, torch.device], torch.Tensor] = {}
    host: dict[int, torch.Tensor] = {}
    rows = []
    for row in mesh.grid:
        out = []
        for j, dev in enumerate(row):
            key = (j, dev)
            if key not in cache:
                if isinstance(array, torch.Tensor):
                    cache[key] = array[j].to(device=dev, dtype=dtype or array.dtype)
                else:
                    if j not in host:
                        host[j] = _host_block(array[j], dtype)
                    cache[key] = host[j].to(dev)
            out.append(cache[key])
        rows.append(tuple(out))
    return PlacedShards(tuple(rows))
