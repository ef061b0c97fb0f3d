"""The exact graph traversal's rounds in one CUDA kernel, G1
(`csrc/beam_traverse.cu`): one block a query runs every round of
`graph/search.py::_plain_rounds` after seeding, with no host wait between
rounds and the same ids, visited log, `n_expanded` and `n_steps`.

`refusal` says whether an exact search goes to the kernel, from its inputs
alone: CUDA f32 vectors under the L2 metric, int32 adjacency, D a multiple
of 4 up to 2048, L <= 256, E <= L, E x R <= 1024 and max_steps x E <= 1024.
Everything else keeps the plain round loop, which is also G1's plain
version: `beam_search` serves CPU tensors with it. `beam_traverse` launches
the kernel, or raises on operands it does not take; `launch` is the same
without the checks, for `beam_search`, which has asked `refusal` and made
the seeded list itself. Each launch is counted in `beam_traverse.launches`
(kernel id G1) and, with tracing on (`utils/profiling.py`), records a
`graph.traverse` span around the launch and adds one to the counter
`graph.traverse_kernel`.

The kernel's distance is `_gathered_distance`'s formula in f32,
max(qn + vn - 2 q.v, 0), its sums taken in another order than PyTorch's,
so a distance can differ from the plain loop's in its last bits and a tie
between two candidates within that rounding may break the other way.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diskrag_tpu_torch.kernels import _build
from diskrag_tpu_torch.kernels.launches import count
from diskrag_tpu_torch.ops.distance import Metric
from diskrag_tpu_torch.utils import profiling

MAX_DIM = 2048
MAX_WIDTH = 256
MAX_FRESH = 1024  # E x R
MAX_VISITED = 1024  # max_steps x E


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


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 6
             + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p])


@functools.cache
def _launcher():
    fn = _build.load("beam_traverse").beam_traverse_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


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
    return launch(vectors, adjacency, queries, cand_ids, cand_dists, expanded,
                  expand_width=expand_width, max_steps=max_steps)


def launch(vectors, adjacency, queries, cand_ids, cand_dists, expanded, *,
           expand_width: int, max_steps: int) -> tuple[torch.Tensor, ...]:
    """`beam_traverse` without its checks, for a caller whose operands
    `refusal` has passed and whose seeded list it made itself."""
    n, d = vectors.shape
    b, l = cand_ids.shape
    dev = vectors.device
    queries, cand_ids, cand_dists = queries.contiguous(), cand_ids.contiguous(), cand_dists.contiguous()
    seed_exp = expanded.contiguous().view(torch.uint8)
    v = max_steps * expand_width
    ids = torch.empty((b, l), dtype=torch.int32, device=dev)
    dists = torch.empty((b, l), dtype=torch.float32, device=dev)
    visited_ids = torch.empty((b, v), dtype=torch.int32, device=dev)
    visited_dists = torch.empty((b, v), dtype=torch.float32, device=dev)
    n_expanded = torch.zeros((b,), dtype=torch.int32, device=dev)
    n_steps = torch.zeros((), dtype=torch.int32, device=dev)
    if b == 0:
        return ids, dists, visited_ids, visited_dists, n_expanded, n_steps
    with profiling.span("graph.traverse", batch=b):
        err = _launcher()(
            vectors.data_ptr(), adjacency.data_ptr(), queries.data_ptr(), cand_ids.data_ptr(),
            cand_dists.data_ptr(), seed_exp.data_ptr(), n, b, d, adjacency.shape[1], l,
            expand_width, max_steps, ids.data_ptr(), dists.data_ptr(), visited_ids.data_ptr(),
            visited_dists.data_ptr(), n_expanded.data_ptr(), n_steps.data_ptr(), dev.index,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    count(beam_traverse)
    profiling.count("graph.traverse_kernel")
    _build.check(err, "beam_traverse_launch")
    return ids, dists, visited_ids, visited_dists, n_expanded, n_steps


beam_traverse.launches = 0


def reset_launch_counts() -> None:
    beam_traverse.launches = 0
