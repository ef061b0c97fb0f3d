"""The exact graph search on the card in two CUDA kernels launched back to
back: G2 (`csrc/beam_seed.cu`) makes the seeded candidate list, G1
(`csrc/beam_traverse.cu`) runs every round of
`graph/search.py::_plain_rounds` from it, one block a query, with no host
wait between rounds and the same ids, visited log, `n_expanded` and
`n_steps`. Between the two no PyTorch op runs and no device value is read
on the host.

`refusal` says whether an exact search goes to the kernels, from its
inputs alone: CUDA f32 vectors under the L2 metric, int32 adjacency, D a
multiple of 4 up to 2048, L <= 256, E <= L, E x R <= 1024 and max_steps x E
<= 1024. Everything else keeps the plain seeding and round loop
(`_seed_candidates`, `_plain_rounds`), which are also G2's and G1's plain
versions: `beam_search` serves CPU tensors with them. `seed_and_traverse`
is the search on the kernels, for `beam_search`, which has asked `refusal`.
`beam_seed` and `beam_traverse` launch one kernel each from checked
operands, or raise on operands they do not take. Each launch is counted in
`beam_seed.launches` (kernel id G2) or `beam_traverse.launches` (G1) and,
with tracing on (`utils/profiling.py`), records a `graph.seed` or a
`graph.traverse` span around the launch and adds one to the counter
`graph.seed_kernel` or `graph.traverse_kernel`; a G1 launch on the warp
path (`traverse_plan`) also adds one to `graph.traverse_warp_path`.

Both kernels compute `_gathered_distance`'s formula in f32,
max(qn + vn - 2 q.v, 0), their sums taken in another order than PyTorch's,
so a distance can differ from the plain path's in its last bits and a tie
between two candidates within that rounding may break the other way.

G2's grid is query tiles x seed slices, taken from B, S, L and D alone
(`seed_plan`): at B = 1 the seeds spread over enough slices to fill the
card, at B = 512 sixteen queries a tile, so each seed row is read 32 times
and not 512. With several slices the last block of a tile to finish merges
the slices' lists; it finds that it is last through a counter of the
tile's finished slices, which it sets back to zero (`_tile_counters`).

G1's launcher takes its path and block from E, R and L alone: where E x R
and L are at most 64 a round's cut, dedupe and merge run in one warp's
registers (the warp path: the exact cells' L 32, E 1, R 48), with just
enough threads to score every neighbour row in one pass; wider shapes (the
wave build's E 8 x R 64, L up to 256) take the block path, whose cut is a
block-wide sort. Both are one algorithm; only the number of keys a round
orders differs. `traverse_plan` reads the same two limits for the counter.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from diskrag_tpu_torch.kernels import _build
from diskrag_tpu_torch.kernels.launches import count
from diskrag_tpu_torch.ops.distance import Metric
from diskrag_tpu_torch.utils import profiling

MAX_DIM = 2048
MAX_WIDTH = 256
MAX_FRESH = 1024  # E x R
MAX_VISITED = 1024  # max_steps x E

# G2's plan (csrc/beam_seed.cu's constants)
SEED_TILE = 16  # queries a tile, at most
SEED_CHUNK = 128  # seeds scored between two selections
SEED_MERGE_KEYS = 4096  # slices x L of a query, at most
SEED_TILE_BYTES = 48 * 1024  # a tile's scoring state in shared memory, at most
SEED_BLOCKS_PER_SM = 2

WARP_KEYS = 64  # G1's warp path: E x R and L at most this (csrc/beam_traverse.cu's kWarpKeys)


def refusal(
    vectors: torch.Tensor,
    adjacency: torch.Tensor,
    queries: torch.Tensor,
    *,
    search_width: int,
    expand_width: int,
    max_steps: int,
    metric: str,
) -> str | None:
    """Why G1 does not serve this exact search, or None where it does. The
    device is asked last, so that on the CPU each other reason shows."""
    d = vectors.shape[-1]
    r = adjacency.shape[-1]
    if Metric(metric) != Metric.L2:
        return f"metric {metric}: G1 scores L2 only"
    if vectors.dtype != torch.float32 or queries.dtype != torch.float32:
        return f"vectors {vectors.dtype}, queries {queries.dtype}: G1 takes f32"
    if adjacency.dtype != torch.int32:
        return f"adjacency {adjacency.dtype}: G1 takes int32"
    if vectors.ndim != 2 or adjacency.ndim != 2 or vectors.shape[0] == 0 or r == 0:
        return f"vectors {tuple(vectors.shape)}, adjacency {tuple(adjacency.shape)}"
    if d % 4 or d > MAX_DIM:
        return f"D = {d}: G1 takes a multiple of 4 up to {MAX_DIM}"
    if not expand_width <= search_width <= MAX_WIDTH:
        return f"L = {search_width}, E = {expand_width}: G1 takes E <= L <= {MAX_WIDTH}"
    if expand_width * r > MAX_FRESH:
        return f"E x R = {expand_width * r}: G1 takes up to {MAX_FRESH}"
    if not 0 < max_steps * expand_width <= MAX_VISITED:
        return f"max_steps x E = {max_steps * expand_width}: G1 takes 1 to {MAX_VISITED}"
    if not (vectors.is_contiguous() and adjacency.is_contiguous()) or vectors.data_ptr() % 16:
        return "G1 takes contiguous vectors and adjacency, the vectors 16-byte aligned"
    if not (vectors.is_cuda and adjacency.device == vectors.device
            and queries.device == vectors.device):
        return f"vectors on {vectors.device}: G1 runs on a CUDA device, every operand on it"
    return None


_G1_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p])
_G2_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p])


@functools.cache
def _launcher(stem: str, defines: tuple[str, ...] = ()):
    fn = getattr(_build.load(stem, defines), f"{stem}_launch")
    fn.argtypes = _G1_ARGTYPES if stem == "beam_traverse" else _G2_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def seed_tile_bytes(qt: int, d: int, l: int) -> int:
    """Shared bytes of G2's scoring state for a tile of `qt` queries: the
    queries, their norms, a chunk's keys and two running lists a query."""
    return 4 * qt * d + 8 * ((qt + 1) // 2) + 8 * qt * SEED_CHUNK + 16 * qt * l


def seed_plan(b: int, s: int, l: int, d: int, sms: int) -> tuple[int, int, int]:
    """G2's grid from the shapes alone: (qt queries a tile, tiles, ns seed
    slices). A tile takes up to `SEED_TILE` queries (a power of two, its
    scoring state within `SEED_TILE_BYTES`), so that one read of a seed row
    serves them all; the slices then spread the S seeds over about
    `SEED_BLOCKS_PER_SM` blocks an SM, each slice a chunk or more, with at
    most `SEED_MERGE_KEYS` slice-list keys a query for the last block to
    merge. Fewer seeds than L take one slice: they are not sorted."""
    qt = 1
    while qt < min(b, SEED_TILE) and seed_tile_bytes(2 * qt, d, l) <= SEED_TILE_BYTES:
        qt *= 2
    tiles = -(-b // qt)
    if s < l:
        return qt, tiles, 1
    ns = max(1, min(SEED_BLOCKS_PER_SM * sms // max(tiles, 1), SEED_MERGE_KEYS // l,
                    -(-s // SEED_CHUNK)))
    return qt, tiles, -(-s // -(-s // ns))  # no empty slice


def traverse_plan(e: int, r: int, l: int) -> bool:
    """Whether G1 takes its warp path at these shapes: E x R and L at most
    `WARP_KEYS`, the launcher's own test."""
    return e * r <= WARP_KEYS and l <= WARP_KEYS


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_tile_done: dict = {}
_tile_lock = threading.Lock()


def _tile_counters(dev: torch.device, stream: int, tiles: int) -> torch.Tensor:
    """G2's finished-slice counters for launches on `stream`, one a tile.
    Each launch leaves them zero (its last block of a tile resets the
    tile's), so one buffer serves every launch that stream orders; it is
    made, zeroed, only when a launch needs more tiles than it has."""
    key = (dev.index, stream)
    with _tile_lock:
        buf = _tile_done.get(key)
        if buf is None or buf.numel() < tiles:
            buf = _tile_done[key] = torch.zeros(max(tiles, 256), dtype=torch.int32, device=dev)
    return buf


def _seed_call(vectors, queries, medoid, entry_points, l: int, dev, stream: int):
    """G2's launch arguments (less `zero`, the device and the stream), its
    outputs (cand_ids int32, cand_dists f32, expanded bool, each [B, L])
    and the tensors the arguments point into, all allocated: nothing here
    launches on the device where the medoid and the entry points already
    are int32 on it."""
    n, d = vectors.shape
    b = queries.shape[0]
    if isinstance(medoid, torch.Tensor) and medoid.is_cuda:
        medoid = medoid.to(device=dev, dtype=torch.int32)
        med_ptr, med_val = medoid.data_ptr(), 0
    else:  # a host value: read without a device sync
        med_ptr, med_val = None, int(medoid)
    ep_ptr, s = None, 1
    if entry_points is not None and entry_points.numel():
        entry_points = entry_points.to(device=dev, dtype=torch.int32).contiguous()
        ep_ptr, s = entry_points.data_ptr(), 1 + entry_points.numel()
    qt, tiles, ns = seed_plan(b, s, l, d, _sm_count(dev.index))
    ids = torch.empty((b, l), dtype=torch.int32, device=dev)
    dists = torch.empty((b, l), dtype=torch.float32, device=dev)
    expanded = torch.empty((b, l), dtype=torch.bool, device=dev)
    lists = done = None
    if ns > 1 and b:
        lists = torch.empty((tiles * qt * ns * l,), dtype=torch.int64, device=dev)
        done = _tile_counters(dev, stream, tiles)
    args = (vectors.data_ptr(), queries.data_ptr(), med_ptr, med_val, ep_ptr, n, b, d, s, l, qt,
            ns, None if lists is None else lists.data_ptr(),
            None if done is None else done.data_ptr(), ids.data_ptr(), dists.data_ptr(),
            expanded.data_ptr())
    return args, (ids, dists, expanded), (medoid, entry_points, lists, done)


def _launch_seed(args, zero, dev, stream: int) -> None:
    with profiling.span("graph.seed"):
        err = _launcher("beam_seed")(*args, zero, dev.index, stream)
    count(beam_seed)
    profiling.count("graph.seed_kernel")
    _build.check(err, "beam_seed_launch")


def _launch_traverse(vectors, adjacency, queries, seeded, out, *, expand_width: int,
                     max_steps: int, dev, stream: int, defines: tuple[str, ...] = ()) -> None:
    """G1's launch on `stream`; `defines` picks a build of the kernel with
    those macros (the stage clock's, `G1_STAGE_CLOCK`), never the engine's."""
    n, d = vectors.shape
    cand_ids, cand_dists, expanded = seeded
    b, l = cand_ids.shape
    r = adjacency.shape[1]
    with profiling.span("graph.traverse", batch=b):
        err = _launcher("beam_traverse", defines)(
            vectors.data_ptr(), adjacency.data_ptr(), queries.data_ptr(), cand_ids.data_ptr(),
            cand_dists.data_ptr(), expanded.data_ptr(), n, b, d, r, l, expand_width, max_steps,
            *(t.data_ptr() for t in out), dev.index, stream,
        )
    count(beam_traverse)
    profiling.count("graph.traverse_kernel")
    if traverse_plan(expand_width, r, l):
        profiling.count("graph.traverse_warp_path")
    _build.check(err, "beam_traverse_launch")


def _traverse_outputs(b: int, l: int, v: int, dev, *, zeroed: bool) -> tuple[torch.Tensor, ...]:
    """G1's outputs: ids, dists [B, L], visited_ids, visited_dists [B, V],
    n_expanded [B] (each block writes its own) and n_steps (zero on entry:
    `zeroed`, or G2 zeroes it)."""
    make = torch.zeros if zeroed else torch.empty
    return (torch.empty((b, l), dtype=torch.int32, device=dev),
            torch.empty((b, l), dtype=torch.float32, device=dev),
            torch.empty((b, v), dtype=torch.int32, device=dev),
            torch.empty((b, v), dtype=torch.float32, device=dev),
            make((b,), dtype=torch.int32, device=dev),
            make((), dtype=torch.int32, device=dev))


def beam_seed(
    vectors: torch.Tensor,
    queries: torch.Tensor,
    medoid,
    entry_points: torch.Tensor | None = None,
    *,
    search_width: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The seeded candidate list of an exact L2 search on G2:
    `graph/search.py::_seed_candidates`'s three outputs (cand_ids [B, L]
    int32, cand_dists [B, L] f32, expanded [B, L] bool) from the medoid
    (an int, or a 0-d integer tensor) and the unique `entry_points`
    (int32 [S - 1], or None). vectors [N, D] f32, queries [B, D] f32, all
    on one CUDA device. Raises TypeError on another dtype, ValueError on
    mismatched shapes, operands off one CUDA device or outside the
    kernel's limits."""
    if vectors.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError(f"G2 takes float32 vectors and queries, got {vectors.dtype}, "
                        f"{queries.dtype}")
    if isinstance(medoid, torch.Tensor) and (medoid.ndim or medoid.dtype.is_floating_point):
        raise TypeError(f"G2 takes an integer medoid, got a {tuple(medoid.shape)} {medoid.dtype}")
    if entry_points is not None and (entry_points.dtype != torch.int32 or entry_points.ndim != 1):
        raise TypeError(f"G2 takes 1-d int32 entry_points, got {tuple(entry_points.shape)} "
                        f"{entry_points.dtype}")
    if vectors.ndim != 2 or queries.ndim != 2 or queries.shape[1] != vectors.shape[1]:
        raise ValueError(f"G2: vectors {tuple(vectors.shape)} and queries "
                         f"{tuple(queries.shape)} disagree")
    n, d = vectors.shape
    if n == 0 or d % 4 or d > MAX_DIM:
        raise ValueError(f"G2 takes N > 0 and D a multiple of 4 up to {MAX_DIM}, got "
                         f"{tuple(vectors.shape)}")
    if not 0 < search_width <= MAX_WIDTH:
        raise ValueError(f"G2 takes L from 1 to {MAX_WIDTH}, got {search_width}")
    if not vectors.is_contiguous() or vectors.data_ptr() % 16:
        raise ValueError("G2 takes contiguous vectors, 16-byte aligned")
    on = [vectors, queries] + [t for t in (medoid, entry_points) if isinstance(t, torch.Tensor)]
    if not all(t.is_cuda and t.device == vectors.device for t in on):
        raise ValueError("G2: every operand must be on one CUDA device")
    dev = vectors.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    queries = queries.contiguous()
    args, out, _keep = _seed_call(vectors, queries, medoid, entry_points, search_width, dev,
                                  stream)
    if queries.shape[0]:
        _launch_seed(args, None, dev, stream)
    return out


def beam_traverse(
    vectors: torch.Tensor,
    adjacency: torch.Tensor,
    queries: torch.Tensor,
    cand_ids: torch.Tensor,
    cand_dists: torch.Tensor,
    expanded: torch.Tensor,
    *,
    expand_width: int,
    max_steps: int,
) -> tuple[torch.Tensor, ...]:
    """Run the rounds of an exact L2 search on G1 from its seeded state.

    vectors [N, D] f32, adjacency [N, R] int32, queries [B, D] f32, and the
    seeded list: cand_ids [B, L] int32, cand_dists [B, L] f32, expanded
    [B, L] bool. Returns (ids [B, L], dists [B, L], visited_ids [B, V],
    visited_dists [B, V], n_expanded [B] int32, n_steps 0-d int32), V =
    max_steps * E: `_plain_rounds`'s state after its last round. Raises
    TypeError on another dtype, ValueError on mismatched shapes, operands
    off one CUDA device or outside the kernel's limits (`refusal`)."""
    want = [(vectors, torch.float32, "vectors"), (adjacency, torch.int32, "adjacency"),
            (queries, torch.float32, "queries"), (cand_ids, torch.int32, "cand_ids"),
            (cand_dists, torch.float32, "cand_dists"), (expanded, torch.bool, "expanded")]
    for t, dtype, name in want:
        if t.dtype != dtype:
            raise TypeError(f"G1 takes {dtype} {name}, got {t.dtype}")
    if vectors.ndim != 2 or adjacency.ndim != 2 or queries.ndim != 2 or cand_ids.ndim != 2:
        raise ValueError("G1 takes 2-d vectors, adjacency, queries and candidate lists")
    n, d = vectors.shape
    b, l = cand_ids.shape
    if adjacency.shape[0] != n or queries.shape != (b, d):
        raise ValueError(f"G1: vectors {tuple(vectors.shape)}, adjacency "
                         f"{tuple(adjacency.shape)} and queries {tuple(queries.shape)} disagree")
    if cand_dists.shape != (b, l) or expanded.shape != (b, l):
        raise ValueError(f"G1: cand_ids {(b, l)}, cand_dists {tuple(cand_dists.shape)} and "
                         f"expanded {tuple(expanded.shape)} disagree")
    if not all(t.is_cuda and t.device == vectors.device for t, _, _ in want):
        raise ValueError("G1: every operand must be on one CUDA device")
    why = refusal(vectors, adjacency, queries, search_width=l, expand_width=expand_width,
                  max_steps=max_steps, metric=Metric.L2.value)
    if why is not None:
        raise ValueError(why)
    dev = vectors.device
    out = _traverse_outputs(b, l, max_steps * expand_width, dev, zeroed=True)
    if b:
        seeded = (cand_ids.contiguous(), cand_dists.contiguous(), expanded.contiguous())
        _launch_traverse(vectors, adjacency, queries.contiguous(), seeded, out,
                         expand_width=expand_width, max_steps=max_steps, dev=dev,
                         stream=torch.cuda.current_stream(dev).cuda_stream)
    return out


def seed_and_traverse(vectors, adjacency, queries, medoid, entry_points, *, search_width: int,
                      expand_width: int, max_steps: int) -> tuple[torch.Tensor, ...]:
    """An exact L2 search on the card whose operands `refusal` has passed:
    G2's seeded list, then G1's rounds from it, `beam_traverse`'s outputs.
    Every output of both is allocated first; then G2 goes to the stream
    inside the `graph.seed` span and G1 right after it inside
    `graph.traverse`, with no PyTorch op between them (G2 also zeroes G1's
    round counter)."""
    b, l = queries.shape[0], search_width
    dev = vectors.device
    queries = queries.contiguous()
    if b == 0:
        return _traverse_outputs(0, l, max_steps * expand_width, dev, zeroed=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args, (cand_ids, cand_dists, expanded), _keep = _seed_call(
        vectors, queries, medoid, entry_points, l, dev, stream)
    out = _traverse_outputs(b, l, max_steps * expand_width, dev, zeroed=False)
    _launch_seed(args, out[-1].data_ptr(), dev, stream)
    _launch_traverse(vectors, adjacency, queries, (cand_ids, cand_dists, expanded), out,
                     expand_width=expand_width, max_steps=max_steps, dev=dev, stream=stream)
    return out


beam_seed.launches = 0
beam_traverse.launches = 0


def reset_launch_counts() -> None:
    beam_seed.launches = 0
    beam_traverse.launches = 0
