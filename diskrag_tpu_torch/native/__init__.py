"""The host tier's record reader: ctypes over `io_native.cpp` (counterpart
of `diskrag_tpu/native/`).

`RecordReader` is the batched equivalent of the reference's
`MMapNodeReader` (reference io/diskann_persist.py:209-235): an mmap'd
record file behind an LRU cache, serving batched id -> vector gathers for
the host-side rerank. The library is compiled from this package's copy
of the source on first use (`kernels/_build.py::load_host`, into
`build/diskrag_tpu_torch/`). Unlike the JAX package's reader, it never
drops to numpy on its own: `native=False` asks for the numpy path, and
otherwise a library that does not build or a file it cannot open raises.
`is_native` says which path a reader runs.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_configured: set[int] = set()


def load_library() -> ctypes.CDLL:
    """The record reader's library, built at first use; raises if it
    cannot be built."""
    from diskrag_tpu_torch.kernels._build import load_host

    lib = load_host("io_native")
    if id(lib) not in _configured:
        lib.drag_open.restype = ctypes.c_void_p
        lib.drag_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ]
        lib.drag_get_vectors.restype = ctypes.c_int
        lib.drag_get_vectors.argtypes = [
            ctypes.c_void_p, _I64P, ctypes.c_int64, _F32P, ctypes.c_int32,
        ]
        lib.drag_get_nodes.restype = ctypes.c_int
        lib.drag_get_nodes.argtypes = [
            ctypes.c_void_p, _I64P, ctypes.c_int64, _F32P, _I32P, ctypes.c_int32,
        ]
        for name in ("drag_cache_hits", "drag_cache_misses"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.drag_close.restype = None
        lib.drag_close.argtypes = [ctypes.c_void_p]
        _configured.add(id(lib))
    return lib


class RecordReader:
    """Batched reader over a packed record file (`index.dat`: per node
    float32[dim] then uint32[r] neighbour ids, 0xFFFFFFFF padding)."""

    def __init__(
        self,
        path: str | os.PathLike,
        n: int,
        dim: int,
        r: int,
        cache_capacity: int = 1024,
        native: bool = True,
    ):
        self.path = str(path)
        self.n, self.dim, self.r = int(n), int(dim), int(r)
        self.record_size = 4 * (self.dim + self.r)
        self._handle = None
        self._lib = None
        self._mm = None
        if native:
            self._lib = load_library()
            self._handle = self._lib.drag_open(
                self.path.encode(), self.n, self.dim, self.r, int(cache_capacity)
            )
            if not self._handle:
                raise OSError(
                    f"cannot open record file {self.path} as {self.n} records of "
                    f"{self.record_size} bytes (missing or too short)"
                )
        else:
            self._mm = np.memmap(self.path, dtype=np.uint8, mode="r",
                                 shape=(self.n, self.record_size))

    @property
    def is_native(self) -> bool:
        """True when the compiled reader serves the gathers (the default),
        False on the numpy path the caller asked for."""
        return self._lib is not None

    def get_vectors(self, ids: np.ndarray, n_threads: int = 4) -> np.ndarray:
        """ids [C] -> float32 [C, dim]; out-of-range ids give zeros."""
        ids = np.ascontiguousarray(ids, np.int64)
        out = np.empty((len(ids), self.dim), np.float32)
        if self._lib is not None:
            rc = self._lib.drag_get_vectors(
                self._live_handle(), ids.ctypes.data_as(_I64P), len(ids),
                out.ctypes.data_as(_F32P), n_threads,
            )
            if rc != 0:
                raise RuntimeError(f"drag_get_vectors failed rc={rc}")
            return out
        ok = (ids >= 0) & (ids < self.n)
        raw = self._mm[np.where(ok, ids, 0), : 4 * self.dim]
        out[:] = raw.view(np.float32).reshape(len(ids), self.dim)
        out[~ok] = 0.0
        return out

    def get_nodes(self, ids: np.ndarray, n_threads: int = 4) -> tuple[np.ndarray, np.ndarray]:
        """ids [C] -> (vectors [C, dim], neighbours [C, r] int32, -1 pad)."""
        ids = np.ascontiguousarray(ids, np.int64)
        vecs = np.empty((len(ids), self.dim), np.float32)
        nbrs = np.empty((len(ids), self.r), np.int32)
        if self._lib is not None:
            rc = self._lib.drag_get_nodes(
                self._live_handle(), ids.ctypes.data_as(_I64P), len(ids),
                vecs.ctypes.data_as(_F32P), nbrs.ctypes.data_as(_I32P), n_threads,
            )
            if rc != 0:
                raise RuntimeError(f"drag_get_nodes failed rc={rc}")
            return vecs, nbrs
        ok = (ids >= 0) & (ids < self.n)
        raw = self._mm[np.where(ok, ids, 0)]
        vecs[:] = raw[:, : 4 * self.dim].view(np.float32).reshape(len(ids), self.dim)
        nb = raw[:, 4 * self.dim:].view(np.uint32).reshape(len(ids), self.r)
        nbrs[:] = np.where(nb == 0xFFFFFFFF, -1, nb.astype(np.int64)).astype(np.int32)
        vecs[~ok] = 0.0
        nbrs[~ok] = -1
        return vecs, nbrs

    def _live_handle(self):
        # the C functions do not null-check the handle: a gather after
        # close() would dereference nullptr and kill the process
        if not self._handle:
            raise RuntimeError(f"record reader of {self.path} is closed")
        return self._handle

    def cache_stats(self) -> dict:
        if self._lib is None or not self._handle:
            return {"hits": 0, "misses": 0, "native": False}
        return {
            "hits": int(self._lib.drag_cache_hits(self._handle)),
            "misses": int(self._lib.drag_cache_misses(self._handle)),
            "native": True,
        }

    def close(self) -> None:
        if self._lib is not None and self._handle:
            self._lib.drag_close(self._handle)
            self._handle = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
