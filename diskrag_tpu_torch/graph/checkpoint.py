"""Mid-build checkpoint and resume for long graph builds (counterpart of
`diskrag_tpu/graph/checkpoint.py`, the same files, so a checkpoint
written by either package resumes in the other).

The dominant phase of a multi-million-point build is the IVF kNN pass,
whose results accumulate on the host: checkpointing it needs no device
fetch, only periodic atomic writes of the accumulated tables.

A checkpoint directory holds:
  - tag.json        — the build configuration + a dataset fingerprint;
                      a mismatch invalidates every saved phase (stale
                      checkpoints are deleted, never silently reused)
  - <phase>.npz     — completed-phase arrays (e.g. the full kNN tables)
  - <phase>_partial.npz — in-progress accumulation + resume cursor

Distance tables are stored as bfloat16 bit patterns (a uint16 view): f16
would overflow on squared L2 at SIFT scale (128 * 255^2 >> 65504) and
f32 doubles the write volume for precision the prune pass does not use.
The bit patterns are made by torch's float32 -> bfloat16 conversion
(round to nearest even), with NaN written as the quiet NaN of its sign,
as `ml_dtypes` writes it.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pathlib

import numpy as np
import torch

logger = logging.getLogger(__name__)


def dataset_fingerprint(vectors, sample_rows: int = 1024) -> str:
    """Cheap content fingerprint: shape + dtype + sha256 of a strided
    row sample (hashing all N*D bytes would cost more than it protects
    against; a strided sample catches swapped or regenerated datasets).
    Takes a numpy array or a tensor on any device (one small fetch) and
    gives the same hex for the same data either way."""
    n = vectors.shape[0]
    idx = np.arange(0, n, max(1, n // sample_rows))[:sample_rows]
    if isinstance(vectors, torch.Tensor):
        rows = vectors[torch.as_tensor(idx, device=vectors.device)].cpu().numpy()
    else:
        rows = np.asarray(vectors[idx])
    h = hashlib.sha256()
    h.update(str((tuple(vectors.shape), str(rows.dtype))).encode())
    h.update(np.ascontiguousarray(rows).tobytes())
    return h.hexdigest()[:16]


def _save_npz_atomic(path: pathlib.Path, arrays: dict) -> None:
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _read_npz(path: pathlib.Path) -> dict:
    """The arrays of an .npz file. Members stored uncompressed (what
    `np.savez` writes) are each read in one piece from their offset in the
    file and checked against the zip's CRC-32, which is what `np.load`
    checks but at a third of its cost (it reads a member through the zip
    stream in small chunks, three copies in all): the resumed build's whole
    kNN stage is this read. A file with compressed members goes through
    `np.load`. A broken file raises what `np.load` raises (ValueError,
    OSError, EOFError, zipfile.BadZipFile)."""
    import struct
    import zipfile
    import zlib

    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        infos = zf.infolist()
        if any(i.compress_type != zipfile.ZIP_STORED for i in infos):
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        for info in infos:
            f.seek(info.header_offset)
            local = f.read(30)
            if len(local) < 30 or local[:4] != b"PK\x03\x04":
                raise zipfile.BadZipFile(f"bad local header for {info.filename}")
            n_name, n_extra = struct.unpack("<HH", local[26:30])
            start = info.header_offset + 30 + n_name + n_extra
            f.seek(start)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            if dtype.hasobject:
                raise ValueError(f"{info.filename}: object arrays are not loaded")
            header_len = f.tell() - start
            arr = np.empty(int(np.prod(shape)), dtype)
            if header_len + arr.nbytes != info.file_size:
                raise zipfile.BadZipFile(f"{info.filename}: size does not match its header")
            if f.readinto(memoryview(arr).cast("B")) != arr.nbytes:
                raise EOFError(f"{info.filename}: truncated")
            f.seek(start)
            crc = zlib.crc32(arr, zlib.crc32(f.read(header_len)))
            if crc != info.CRC:
                raise zipfile.BadZipFile(f"{info.filename}: CRC-32 mismatch")
            name = info.filename[:-4] if info.filename.endswith(".npy") else info.filename
            out[name] = arr.reshape(shape, order="F" if fortran else "C")
    return out


def pack_bf16(a: np.ndarray) -> np.ndarray:
    """float32 values -> bfloat16 bit patterns (uint16), rounded to
    nearest even; NaN becomes 0x7FC0 or 0xFFC0 by its sign."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    bits = torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    nan = np.isnan(a)
    if nan.any():
        bits = np.where(nan, np.where(np.signbit(a), 0xFFC0, 0x7FC0), bits).astype(np.uint16)
    return bits


def unpack_bf16(a: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32 values (exact)."""
    bits = np.ascontiguousarray(a, dtype=np.uint16).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16).to(torch.float32).numpy()


class BuildCheckpoint:
    """Tagged phase checkpoints under one directory.

    `tag` must capture every input that determines the build's output
    (params, seed, dataset fingerprint). On open, a tag mismatch wipes
    the directory's phase files so a changed build never resumes from
    another build's state.
    """

    def __init__(self, directory: str | os.PathLike, tag: dict):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.tag = {k: tag[k] for k in sorted(tag)}
        tag_path = self.dir / "tag.json"
        old = None
        if tag_path.exists():
            try:
                old = json.loads(tag_path.read_text())
            except ValueError:
                old = None
        # phase files with a missing or unreadable tag are as stale as a
        # mismatched one: adopting them would resume another build's state
        if old != self.tag:
            stale = list(self.dir.glob("*.npz")) + list(self.dir.glob("*.npz.tmp"))
            if stale:
                logger.info(
                    "checkpoint tag %s — dropping %d stale file(s) in %s",
                    "changed" if old is not None else "missing", len(stale), self.dir,
                )
            for p in stale:
                p.unlink()
        tmp = tag_path.with_name("tag.json.tmp")
        tmp.write_text(json.dumps(self.tag, indent=1))
        os.replace(tmp, tag_path)

    def _path(self, phase: str) -> pathlib.Path:
        return self.dir / f"{phase}.npz"

    def has(self, phase: str) -> bool:
        return self._path(phase).exists()

    def save(self, phase: str, **arrays: np.ndarray) -> None:
        _save_npz_atomic(self._path(phase), arrays)

    def load(self, phase: str) -> dict | None:
        p = self._path(phase)
        if not p.exists():
            return None
        import zipfile

        try:
            return _read_npz(p)
        except (ValueError, OSError, EOFError, zipfile.BadZipFile) as e:
            # a torn or corrupt file: treat it as absent and rebuild the
            # phase (np.load raises BadZipFile on a truncated .npz, which
            # is neither a ValueError nor an OSError)
            logger.warning("unreadable checkpoint %s (%s) — ignoring", p, e)
            return None

    def clear(self, phase: str) -> None:
        self._path(phase).unlink(missing_ok=True)
