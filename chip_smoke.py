"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `diskrag_tpu_torch/csrc/` (into
`build/diskrag_tpu_torch/`), checks in their SASS that B1's int8 and bf16
kernels, the partial kernels of B2 / B3 and of B6 and M1 run their products
on wgmma, holds each kernel against its plain PyTorch version on the card
(B1 int8 and bf16 at row widths 36 to 1536, 1 to 4096 queries and NB 128 to
32768; B4 on those
blocks, on ties with signed zeros and -inf rows, at NB = 32768 and with kk >
NB; B2 / B3 / B6 at row widths 16 to 192 bytes, 1 to 4096 queries and more
than 256 segments, B6 also against B3; B5 in both its forms, gathered and by
id with and without the residual terms, both ways of reading the tables;
by id also at the capacity ladder's rpq64 round over code tables of 1M and
10M rows), then serves the flat index end to end at
the benchmark's sizes (1,000,000 x 128 and 200,000 x 128 vectors, 1000
queries, k = 10)
through `build_index_from_vectors` and `SearchEngine.search_batch` — with
the per-row int8 scan (kernels B1, B4), with `flat_precision:
int8_packed` (kernels B2, B3) and, at 1,000,000, with `flat_precision:
bf16` (B1's bf16 form, B4) — serves the bench's headline point (2048
queries, the batch tiled, at rerank width 20 over the 200k packed index:
one B3 launch a batch, NB 512, the cut fused at kk 20; recall@10 gate 0.96
over the leading 1000 rows) and holds B3 bit for bit at that shape, serves
one 1M batch of `FlatIndex(use_fused=False)` (the bf16 path a caller
chooses; no kernel may launch; recall@10 gate 0.97), runs the pipelined
fold (B6) through its wrapper at the 1M shape, builds the Vamana graph at 200,000 x 128 on the
card (B1 and B4 inside its kNN pass), sweeps exact and PQ-guided
traversal over it (the ADC lookup by id, kernel B5, once a round), serves
the default vamana configuration through the same entry points (with the
device launches a traversal round costs), and checks recall@10 against an
exact ground truth. It then holds the matmul-only
probe (kernel M1) against its plain version, runs the fused-scan
microbenchmark (`diskrag_tpu_torch.tools.fused_scan_micro`) in process at
200,000 rows (and its M1 and hierarchical stages at 1,000,000), checking
that every stage launched the kernel it is named for, and serves the
vamana collection over HTTP (`diskrag_tpu_torch.api.create_app` on a
socket on 127.0.0.1), sending a few requests one after the other. Phase
`main-host-tier` first holds G1 (the exact traversal's rounds in one
kernel) against the plain rounds from the same seeded state on its
1,000,000-point degree-48 graph at the exact cell's shape (L 32, E 1, the
graph's entry points; B = 1 and 512), bit for bit on the same graph with
integer vectors and statistically on the float ones, and times it beside
the plain rounds and its bound (`main-graph` does the same at 200,000, L
16, E 8); G1's entry in the `kernels` line holds those rows and its
launches in every phase that reaches it. It holds G2 (the exact search's
seeded list in one kernel) against the plain seeding at the same shape
(bit for bit on the integer graph, the share of identical rows on the
float one) and times it beside the plain seeding and its bound; every
phase that reaches G1 pins G2 at one launch a search too. It then serves
the host tier through `SearchEngine(serving_mode="host_tier")`: the JAX bench's 1M host-tier configuration (degree-48
graph, int8 rows, the f32 vectors in the packed record file read by the
native reader, the rerank on the host; recall@10 gates 0.985 at L = 32 and
0.99 at L = 48), the default 200k vamana collection in its residual-PQ
mode (B5 by id once a round; recall within 0.01 of mode "auto"; one HTTP
/search) and in bf16 mode. Phase `main-host-tier-ladder` serves the JAX
package's capacity ladder (`benchmarks/host_tier_multi.py`) at 1,000,000
points through the port's modules: one R = 32 graph
(`build_vamana_knn(degree_bound=32, knn_probe=8)`, B1 + B4 once a 4096-row
block, each stage's seconds and peak device bytes) with the record file,
then iq8, iq4c1024 and rpq64 trained in turn and swapped in
(`persist.replace_pq_artifacts`), each served by
`HostTierIndex.from_store(mode=...).search` at the JAX bench's widths, E =
8 (recall@10 gated at the JAX package's 1M figures less 0.01; B5 launches
equal to the rounds in the rpq64 rows, no kernel in the iq rows), and B5 by
id held bit for bit at one rpq64 round's real operands (m = 64, 256
candidates a query, 1024 cells), also lifted onto a 10,000,000-row code
table. Phase `main-angular` runs the JAX package's angular configuration
(`benchmarks/angular_bench.py`, through `diskrag_tpu_torch.tools.
angular_bench.run` in process): 1,200,000 unit-normalized x 128 points,
the R = 32 graph (B1 + B4 once a 4096-row block, 293 each), exact and
iq8 traversal at L = 16 / 32, rpq32 at L = 32 / 64 and rpq64 with 2048
cells at L = 64 / 96 (recall@10 gated at the JAX package's figures less
0.01, rpq32 less 0.03; B5 launches equal to the rpq rows' rounds, no
kernel in the exact and iq8 rows), exact traversal at L = 48, B5 by id bit
for bit at one real rpq64 round (1000 x 128 candidates, m = 64, 2048
cells), B1's norm-free form and B4 bit for bit at the cosine build's shape
(4096 x 1.2M, NB 4096, kk 260), then the native cosine build through
`build_index_from_vectors(metric="cosine")` (293 B1 launches, each
norm-free as its operands show, and 293 B4) served by `SearchEngine.
search_batch` at l_search 32 and 48 (exact traversal on the cosine metric: no kernel; recall@10
gated at the documented native-cosine figures less 0.01 and within 0.01 of
the L2-on-normalized rows; the distances 1 - cos, in [0, 2]); both builds'
share of points without an in-edge is printed. Phase `main-ivf` builds the IVF-Flat index
through `build_index_from_vectors(index_type="ivf")` at 1,000,000 and
200,000 points and serves it through `SearchEngine.search_batch` at
n_probe 8 and 16 (recall@10 gated at the JAX package's v5e figures less
0.01; no kernel may launch), then sweeps it over n_probe 8 to 64 with int8
and bf16 tiles; phase `main-graph-ivfknn` builds the degree-48 graph at
1,000,000 with the IVF kNN backend (B1 and B4 must not launch; exact
traversal recall gated at 0.985) and, at 200,000, twice with one
checkpoint directory (the second build's kNN stage under a tenth of the
first's, its adjacency bit-identical). Phase `main-streaming` runs the JAX
streaming bench's protocol (`diskrag_tpu_torch.tools.streaming_bench`, in
process): a degree-48 base of 200,000 points, 131,072 more streamed in
batches of 1024 through `StreamingIndex` (buffer 32,768, kNN merge); it
gates recall@10 at two mid-stream probes and at the end (the JAX
package's v5e figures less 0.01), four merges and exactly 8 launches each
of B1 and B4 a merge, holds B1 and B4 bit for bit at one merge sub-wave's
operands (L2 with the 1e15 pad rows, cosine with zeroed pad codes), then
runs one rebuild-path merge (B1 / B4 through `build_vamana_knn`), one
`merge_method="wave"` merge (G1 once a wave) and a delete of 10% of the live ids
with `consolidate` (no tombstoned id served; recall within 0.01), beside
the JAX package's consolidate policy on the same state (printed). Phase
`pipelined` rows sit in every phase that has an engine live (flat-1M-int8,
flat-200k-packed and -1M-packed, vamana-200k-default, ivf-1M-int8,
host-tier-200k-pq, the streaming engine of api-streaming-200k and the
sharded cell's modes "auto" and "sharded_flat"): `SearchEngine.
search_pipelined` over 16 batches of 512 text queries (8 in flight; 4
batches on the sharded cell) beside `search_many` calls of the same
batches, every batch's ids and distances equal to search_many's, the same
launches; the overlap witness (a batch's dispatch began before its
predecessor's event completed) is printed on every row and gated on
sharded_flat, the one path whose device time a batch outlasts the host's
embedding, upload and dispatch; `Event.synchronize` must release the GIL
(on flat-1M-int8); phase `api` also
sends 8 `/search-batch` requests at once to the vamana and the packed
flat 200k collections, each response equal to the same request sent
alone. Phase
`main-wave` builds the 200,000-point index with `build_method="wave"` (its
beam searches on G1, once a wave, no other kernel) and gates exact traversal at L = 48; phase `api-streaming` serves
the default vamana collection over HTTP in streaming mode (`/insert`,
`/search`, `/delete`), then flushes the inserted rows and serves them in
mode "auto". Phase `main-sharded` (before the 1M set is dropped) builds
the 1M set as a sharded index, `build_index_from_vectors(index_type=
"sharded", n_shards=4, write_compat=True)` (B1 + B4 once per 4096-row block
of each 250,000-row shard's kNN pass: 62 each a shard), and serves it on a
4-slot mesh of the one card (`mesh_devices=["cuda:0"] * 4`): mode "auto"
(exact traversal per shard, merged; recall@10 gated at 0.95 at l_search 64;
no kernel), "sharded_flat" (every row scanned in bf16; the ids must be a
top-10 of an independent bf16 / f32 `torch.matmul` + `torch.topk` over all
rows, up to near-ties within 1e-5 of the 10th distance; no kernel) and
"host_tier" (the default residual PQ, m = 4 at 1M: B5 by id once a round
and shard; recall@10 gated at 0.7317 at l_search 64; bf16 mode beside it),
one HTTP `/search` in each mode (answered by the engine just measured) and
the configuration error of a 3-shard index on one card, every step with
its seconds; then `parallel.dryrun.dryrun_multichip(["cuda:0"] * 8)` and two
processes over gloo on the card (`tools.multihost_check`, 2 of 4 shards of
200,000 points each), whose merged ids must equal the single-process
`sharded_search` byte for byte. Profiled figures are taken per recorded
event, so a few dropped events do not bias them, from windows retried
when they lost many; a null one is printed with its reason. Every phase prints JSON lines; the line before the last is the
card's name and power limit as nvidia-smi gives them, and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failure (no card, a build error, a mismatch, low recall, a kernel the
main path did not launch) exits non-zero before that line. Nothing here
imports jax or the JAX package.

    python3 chip_smoke.py --graph-n 1000000

runs the graph phase alone (build, PQ fit, both sweeps, launch counts) at
that many points instead of 200,000 (above 2,000,000 the build's "auto"
kNN backend is the IVF probe, and B1 / B4 must not launch), prints its
lines and the card, and
ends without the last line above: a measurement at another size, not the
smoke test. `python3 chip_smoke.py --streaming-n 1000000` runs the
streaming phase alone at that base (recall gated at the end at 0.9885, the
JAX package's 1M figure less 0.01), the same way; `python3 chip_smoke.py
--sharded-n 4000000` builds and serves the sharded cell alone at that many
points in 4 shards (no recall gates, no HTTP request, no mesh-error case;
the same graphs also traversed by an m = 16 residual PQ), and `--sharded-n
1000000 --shards 1` does so over one graph of the whole set.
`python3 chip_smoke.py --host-tier-n 10000000` runs the ladder phase alone
at that many points (the IVF kNN backend above 2,000,000, 65,536 random
entry points, a checkpoint directory under `build/`; iq8 and rpq64, gated
at the JAX package's 10M figures less 0.01), the same way; `python3
chip_smoke.py --angular-n 1200000` runs the angular phase alone (its
gates apply at 1,200,000 only); `python3 chip_smoke.py --g1-n 1000000`
builds the degree-48 graph at that many points and holds G1 against the
plain rounds at every shape of `G1_CELL_SHAPES` and `G1_SWEEP_SHAPES` and
G2 against the plain seeding at `G2_CELL_SHAPES`, printing G1's and G2's
`kernels` entries. `python3 chip_smoke.py --pq-cell-n 1183514`
runs the PQ-guided cell's kernel shapes alone (B5 at `B5_PQ_CELL_SHAPES`,
B1 at `ROWSCAN_D100`, B1 and B4 at the build's shapes over that many unit
vectors of D = 100), printing their `kernels` entries.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks (dense): int8 tensor cores, f32 outside them,
# HBM3 bandwidth. Bounds are stated against these, beside the power limit.
PEAK_INT8_OPS = 1979e12
PEAK_BF16_OPS = 989e12
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

MAIN_N, MAIN_D, MAIN_B, MAIN_K = 1_000_000, 128, 1000, 10
CMP_N = 200_000
# the bench's headline point (`bench_cuda.py`, `sweep_flat(big_batch=2048)`):
# the 1000 queries tiled to 2048 rows, packed at rerank width 20; at 200k
# it routes to the hierarchical fold B3 at NB 512, the cut fused at kk 20
BIG_B, BIG_RW = 2048, 20


class SmokeFailure(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, after
    one warm-up call (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class ByKernel(dict):
    """{kernel name: device ms per call}; empty, with `null_reason` set,
    where no trustworthy recording was had."""

    null_reason: str | None = None
    windows: int = 0


def _profiled_window(step_fn, steps: int) -> tuple[dict, dict, list]:
    """One profiler window: a warm-up step (the profiler can miss kernels
    at its start), then `steps` recorded calls of `step_fn`, each closed by
    a synchronize. Returns ({name: device ms summed over the window},
    {name: device events recorded}, host ms of each recorded call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    events: list = []  # the active cycle's, taken before the profiler clears them
    wall: list = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps),
                 on_trace_ready=lambda p: events.extend(p.events())) as prof:
        for i in range(steps + 1):
            t = time.perf_counter()
            step_fn()
            torch.cuda.synchronize()
            if i:
                wall.append((time.perf_counter() - t) * 1e3)
            prof.step()
    by: dict = {}
    count: dict = {}
    for e in events:  # device-side work only; the step ranges are annotations
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("ProfilerStep"):
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            count[e.name] = count.get(e.name, 0) + 1
    return by, count, wall


def preloaded_event_ms(fn, reps: int) -> float:
    """Device time of one fn() call by CUDA events with the stream held
    busy (`torch.cuda._sleep`) while the host enqueues the calls, so the
    host's launch path is not in the window: for a call of one kernel, its
    device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled(step_fn, steps: int, *, what: str, single_ms=None, attempts: int = 4):
    """Device time per call by kernel name from a recording the figures
    can trust, retried window by window. The profiler drops device events
    (on the card: a few at a window's edge, sometimes all of them), so a
    call's time is not the window's sum over `steps`: each name's recorded
    events are averaged and multiplied by the times a call runs it
    (its count over `steps`, rounded up). A window is retried when it
    recorded nothing, when it holds under half the events those counts
    imply, and, for a call of one kernel, when the estimate falls under
    half that call's device time by CUDA events (`single_ms()`, asked
    only then). Returns (by-name ms per call, device operations per call,
    share of them recorded, host ms of the window's calls, windows run,
    None) or, after `attempts` windows, (None, None, None, host ms,
    attempts, the reason), emitting the reason on a line of its own."""
    import math

    if os.environ.get("CHIP_SMOKE_NO_PROFILER"):
        reason = "CHIP_SMOKE_NO_PROFILER is set"
        emit({"phase": "profiler", "null": what, "reason": reason, "windows": 0})
        return None, None, None, [], 0, reason
    reason, wall = "no window ran", []
    for w in range(1, attempts + 1):
        by, count, wall = _profiled_window(step_fn, steps)
        n = sum(count.values())
        if n == 0:
            reason = "the profiler recorded no device activity"
            continue
        per_call = {k: math.ceil(c / steps) for k, c in count.items()}
        ops = sum(per_call.values())
        if n < 0.5 * ops * steps:
            reason = f"recorded {n} of the {ops * steps} device events the calls ran"
            continue
        est = {k: by[k] / count[k] * per_call[k] for k in by}
        if single_ms is not None and ops == 1:
            ev = single_ms()
            if sum(est.values()) < 0.5 * ev:
                reason = (f"by-kernel estimate {sum(est.values()):.4f} ms a call against "
                          f"{ev:.4f} ms of device time by CUDA events")
                continue
        return est, ops, n / (ops * steps), wall, w, None
    emit({"phase": "profiler", "null": what, "reason": reason, "windows": attempts})
    return None, None, None, wall, attempts, reason


def device_ms_by_kernel(fn, reps: int) -> ByKernel:
    """Device time per fn() call by kernel name (`torch.profiler`, CUPTI),
    from a window `profiled` can trust. Empty, with `null_reason`, where
    none was had (a machine that does not let CUPTI trace, a recording
    that kept dropping events; `CHIP_SMOKE_NO_PROFILER=1` gives the same
    without asking): the callers then time with CUDA events or report the
    figure as null, beside the reason."""
    fn()
    import torch

    torch.cuda.synchronize()
    by, _, _, _, windows, reason = profiled(
        fn, reps, what=getattr(fn, "__qualname__", "a call"),
        single_ms=lambda: preloaded_event_ms(fn, reps))
    out = ByKernel(by or {})
    out.null_reason, out.windows = reason, windows
    return out


def kernel_device_ms(fn, reps: int) -> float | None:
    """Device time of one fn() call summed over its kernels (the profiler's
    figure; None where it records no device activity)."""
    return sum(device_ms_by_kernel(fn, reps).values()) or None


def device_ms(fn, reps: int) -> tuple[float, str]:
    """Device time of one fn() call and the timer that gave it. With the
    profiler it is the summed durations of every device operation
    recorded: unlike `cuda_ms` that leaves out the gaps between launches,
    so it is the figure for a kernel shorter than the host's time to
    launch it. Where the profiler records nothing, CUDA events around
    back-to-back calls stand in."""
    by_kernel = device_ms_by_kernel(fn, reps)
    if by_kernel:
        return sum(by_kernel.values()), "profiler"
    return cuda_ms(fn, reps), "cuda events"


def b1_bound_ms(b: int, n: int, d: int, nb: int) -> tuple[float, str]:
    """Least time for B1's int8 work over the n valid rows (the table's
    pad rows cannot change the result): the products (2 ops per
    multiply-add) at the int8 tensor-core peak, or each input byte read
    once (codes, the two norm-block rows, query codes and scales) and
    each output byte written once ([B, NB] vals + ids) at HBM bandwidth
    — the larger."""
    t_ops = 2.0 * b * n * d / PEAK_INT8_OPS
    nbytes = n * d + n * 8 + b * d + b * 4 + b * nb * 8
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def b1_bf16_bound_ms(b: int, n: int, d: int, nb: int) -> tuple[float, str]:
    """Least time for B1's bf16 work over the n rows: the products (2 ops
    per multiply-add) at the bf16 tensor-core peak, or each input byte read
    once (bf16 rows and queries, 2 bytes an element; the f32 norm row) and
    each output byte written once ([B, NB] vals + ids) at HBM bandwidth —
    the larger."""
    t_ops = 2.0 * b * n * d / PEAK_BF16_OPS
    nbytes = 2 * n * d + 4 * n + 2 * b * d + b * nb * 8
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def b4_bound_ms(b: int, nb: int, kk: int) -> tuple[float, str]:
    """Least time for B4's work: read the [B, NB] block once, write the
    [B, kk] lanes once; one f32 compare per input element."""
    t_bytes = (b * nb * 4 + b * kk * 4) / PEAK_BYTES
    t_ops = b * nb / PEAK_F32_OPS
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")


def packed_bound_ms(b: int, n: int, d: int, out_ints: int) -> tuple[float, str]:
    """Least time for a packed fold's work (B2, B3, B6) over the n valid
    rows: the products (2 ops per multiply-add) at the int8 tensor-core
    peak, or each input byte read once (codes, the nf row, query codes)
    and each output written once (`out_ints` int32/f32 values per query:
    kk ids with the fused cut, 2 * NB without) at HBM bandwidth — the
    larger."""
    t_ops = 2.0 * b * n * d / PEAK_INT8_OPS
    t_bytes = (n * d + n * 4 + b * d + b * out_ints * 4) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def b5_bound_ms(tables, codes) -> tuple[float, str]:
    """Least time for B5's work on these inputs: bytes only (there are m
    adds per candidate and no products). Each code byte read once, each
    output written once, and each table entry that these codes address
    read once — the distinct (query, subspace, code) triples, at most
    min(C, 256) of a row's 256 entries, counted from the data — at HBM
    bandwidth. Staging a whole table is a kernel's choice, not part of
    the function, so entries no code addresses do not count."""
    import torch

    b, c, m = codes.shape
    used = torch.zeros((b, m, 256), dtype=torch.bool, device=codes.device)
    used.scatter_(2, codes.transpose(1, 2).long(), True)
    t_bytes = (b * c * m + 4 * int(used.sum()) + 4 * b * c) / PEAK_BYTES
    t_ops = b * c * m / PEAK_F32_OPS
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")


def b5_ids_bound_ms(tables, code_table, ids, aux: dict) -> tuple[float, str]:
    """Least time for B5's by-id work on these inputs: bytes only (m + 2
    adds per candidate, no products). Each id read once (8 bytes), each
    distinct code row its ids address (m bytes), each table entry those
    codes address (the distinct (query, subspace, code) triples) and, with
    the residual operands, each distinct id's cell and bias and each
    distinct (query, cell) term, all read once; each output written once."""
    import torch

    b, c = ids.shape
    m = code_table.shape[1]
    safe = ids.clamp(0, code_table.shape[0] - 1)
    distinct = torch.unique(safe)
    codes = code_table[safe]
    used = torch.zeros((b, m, 256), dtype=torch.bool, device=ids.device)
    used.scatter_(2, codes.transpose(1, 2).long(), True)
    nbytes = 8 * b * c + m * distinct.numel() + 4 * int(used.sum()) + 4 * b * c
    if aux:
        cells = aux["point_cell"][safe].long()
        pairs = torch.unique(cells + aux["cell_tables"].shape[1] *
                             torch.arange(b, device=ids.device)[:, None])
        nbytes += 8 * distinct.numel() + 4 * pairs.numel()
    t_bytes = nbytes / PEAK_BYTES
    t_ops = b * c * (m + (2 if aux else 0)) / PEAK_F32_OPS
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")


def b5_ids_row(tables, code_table, ids, aux: dict, reps: int = 50) -> dict:
    """B5's by-id form on card tensors against its plain version (the same
    adds in the same order: bit-identical); then timed on the device
    beside its plain version and the composition of PyTorch operations it
    replaces in a traversal round (`torch` gathers of the codes, the cells
    and the biases, B5's gathered form, the gather of the cell terms, the
    casts and the adds). No single PyTorch call computes the lookup by id,
    so `library_ms` is null."""
    import torch

    from diskrag_tpu_torch.ops import pq_scan

    b, m, _ = tables.shape
    c = ids.shape[1]
    want = pq_scan.adc_lookup_ids_ref(tables, code_table, ids, **aux)
    got = pq_scan.adc_lookup_ids_kernel(tables, code_table, ids, **aux)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    require(mismatches == 0, f"B5 by id differs from its plain version at (B, C, m) = "
            f"{(b, c, m)}, residual={bool(aux)}: {mismatches} entries")
    err = float((got - want).abs().max())

    def composed():
        d = pq_scan.adc_lookup_gathered_kernel(tables, code_table[ids])
        if aux:
            d = (d + torch.gather(aux["cell_tables"], 1, aux["point_cell"][ids].long())
                 + aux["point_bias"][ids])
        return d

    call = lambda: pq_scan.adc_lookup_ids_kernel(tables, code_table, ids, **aux)  # noqa: E731
    ms, timed_by = device_ms(call, 20)
    plain_ms, _ = device_ms(lambda: pq_scan.adc_lookup_ids_ref(tables, code_table, ids, **aux), 5)
    composed_ms, _ = device_ms(composed, 20)
    bound, by = b5_ids_bound_ms(tables, code_table, ids, aux)
    return {"form": "by id", "b": b, "c": c, "m": m, "residual": bool(aux),
            "max_abs_err": err, "mismatches": 0, "match": "bit-identical",
            "ms": ms, "plain_ms": plain_ms, "library_ms": None, "timed_by": timed_by,
            "replaced_ops_ms": composed_ms, "replaced_ops": 8 if aux else 2,
            "ms_launch_to_launch": cuda_ms(call, reps),
            "bound_ms": bound, "bound_by": by}


def _b5_compact(row: dict) -> dict:
    """The keys of a `b5_ids_row` the kernels line carries."""
    keys = ("b", "c", "m", "residual", "max_abs_err", "match", "ms", "timed_by", "plain_ms",
            "replaced_ops_ms", "ms_launch_to_launch", "bound_ms", "bound_by")
    return {k: row[k] for k in keys}


# B1 int8 beyond the comparison set: (rows, D, B, NBs). D = 36 is zero-padded
# to 48-byte rows, D = 100 (GloVe-100) to 112; 960 and 1536 loop over
# 128-byte K boxes
ROWSCAN_D100 = ((50_017, 100, 4096, (4096,)),)
ROWSCAN_CASES = ((3001, 36, 37, (128, 512)), (50_017, 128, 1, (512,)),
                 (50_017, 128, 4096, (4096,)), (5003, 960, 70, (512,)),
                 (4001, 1536, 130, (512,))) + ROWSCAN_D100

# B5: the sweep's and the engine's shapes, a table past 48 KB (m = 64), a
# ragged one, and two with thousands of candidates a query (where a kernel
# that staged each table in shared memory came level with the direct reads)
B5_SHAPES = ((250, 192, 32), (1000, 48, 32), (1000, 24, 16), (1, 48, 64), (37, 5, 8),
             (64, 2048, 16), (64, 4096, 8))


def b5_row(tables, codes, reps: int = 50) -> dict:
    """B5's wrapper on card tensors against its plain version (same order
    of adds: bit-identical), then timed beside the plain version, the one
    PyTorch call that computes the same function (`torch.gather` + `sum`)
    and its bound. B5 runs for a few microseconds, less than the host
    takes to launch it, so `ms`, `plain_ms` and `library_ms` are times on
    the device alone (`device_ms`; `timed_by` says whether the profiler
    gave them or CUDA events had to stand in); the `*_launch_to_launch`
    keys are CUDA events around back-to-back calls, as the longer kernels
    are timed, and measure the host's launch path here."""
    import torch

    from diskrag_tpu_torch.ops import pq_scan

    b, m, _ = tables.shape
    c = codes.shape[1]
    got = pq_scan.adc_lookup_gathered_kernel(tables, codes)
    want = pq_scan.adc_lookup_gathered_ref(tables, codes)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    err = float((got - want).abs().max())
    require(mismatches == 0, f"B5 differs from its plain version at (B, C, m) = {(b, c, m)}: "
            f"{mismatches} entries, max_abs_err {err}")
    idx = codes.long().transpose(1, 2)
    bound, by = b5_bound_ms(tables, codes)
    ms, timed_by = device_ms(lambda: pq_scan.adc_lookup_gathered_kernel(tables, codes), 20)
    plain_ms, _ = device_ms(lambda: pq_scan.adc_lookup_gathered_ref(tables, codes), 5)
    library_ms, _ = device_ms(lambda: torch.gather(tables, 2, idx).sum(1), 20)
    return {"form": "gathered", "b": b, "c": c, "m": m, "max_abs_err": err,
            "mismatches": mismatches, "match": "bit-identical",
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "timed_by": timed_by,
            "ms_launch_to_launch": cuda_ms(
                lambda: pq_scan.adc_lookup_gathered_kernel(tables, codes), reps),
            "plain_ms_launch_to_launch": cuda_ms(
                lambda: pq_scan.adc_lookup_gathered_ref(tables, codes), 10),
            "library_ms_launch_to_launch": cuda_ms(
                lambda: torch.gather(tables, 2, idx).sum(1), reps),
            "bound_ms": bound, "bound_by": by}


# B5 by id at the capacity ladder's rpq64 round (`phase_host_tier_ladder`):
# 1000 queries x E * R = 256 candidates at m = 64, 1024 coarse cells, over
# code tables of 1M and 10M rows
B5_LADDER_SHAPES = ((1000, 256, 64, 1_000_000), (1000, 256, 64, 10_000_000))
B5_LADDER_CELLS = 1024

# The PQ-guided cell's shapes (cudabench `glove100-rpq50-b512`): B5 by id
# once a round at B 512 x E * R = 4 * 32 = 128 candidates, m = 50 (the
# byte-load path, m % 4 != 0), over a code table of GloVe-100's 1,183,514
# rows and 2048 coarse cells: (B, C, m, rows, cells); and the build's kNN
# pass over that many unit vectors of D = 100
B5_PQ_CELL_SHAPES = ((512, 128, 50, 1_183_514, 2048),)
PQ_CELL_N, PQ_CELL_D = 1_183_514, 100


def phase_b5_kernels() -> dict:
    """B5 against its plain version at `B5_SHAPES`: the gathered form,
    then the by-id form over a 200,000-row code table without and with the
    residual operands (256 cells); then by id at `B5_LADDER_SHAPES`, whose
    rows it returns by table size."""
    import torch

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    n = CMP_N
    for b, c, m in B5_SHAPES:
        tables = torch.rand((b, m, 256), generator=g, device=dev) * 40.0
        codes = torch.randint(0, 256, (b, c, m), generator=g, device=dev, dtype=torch.uint8)
        emit({"phase": "kernels", "kernel": "B5", **b5_row(tables, codes)})
        code_table = torch.randint(0, 256, (n, m), generator=g, device=dev, dtype=torch.uint8)
        ids = torch.randint(0, n, (b, c), generator=g, device=dev)
        aux = {"point_cell": torch.randint(0, 256, (n,), generator=g, device=dev,
                                           dtype=torch.int32),
               "point_bias": torch.rand((n,), generator=g, device=dev) * 100.0,
               "cell_tables": torch.rand((b, 256), generator=g, device=dev) * -50.0}
        for a in ({}, aux):
            emit({"phase": "kernels", "kernel": "B5", **b5_ids_row(tables, code_table, ids, a)})
    ladder = {}
    for b, c, m, n_rows in B5_LADDER_SHAPES:
        tables = torch.rand((b, m, 256), generator=g, device=dev) * 40.0
        code_table = torch.randint(0, 256, (n_rows, m), generator=g, device=dev, dtype=torch.uint8)
        ids = torch.randint(0, n_rows, (b, c), generator=g, device=dev)
        aux = {"point_cell": torch.randint(0, B5_LADDER_CELLS, (n_rows,), generator=g, device=dev,
                                           dtype=torch.int32),
               "point_bias": torch.rand((n_rows,), generator=g, device=dev) * 100.0,
               "cell_tables": torch.rand((b, B5_LADDER_CELLS), generator=g, device=dev) * -50.0}
        row = {"rows": n_rows, "cells": B5_LADDER_CELLS,
               **_b5_compact(b5_ids_row(tables, code_table, ids, aux))}
        emit({"phase": "kernels", "kernel": "B5", "shape": "capacity ladder rpq64 round", **row})
        ladder[f"random_{n_rows // 1_000_000}m_rows"] = row
        del code_table, aux
    torch.cuda.empty_cache()
    return ladder


def phase_pq_cell_kernels(smi: str, n: int = PQ_CELL_N) -> dict:
    """B5 at `B5_PQ_CELL_SHAPES` on random operands: the gathered form,
    then by id without and with the residual operands; B1 at
    `ROWSCAN_D100` against its plain versions; then B1 and B4 at the graph
    build's shapes over `n` unit vectors of D = 100 (the draws of
    `make_dataset`, each divided by its norm, as the cell's set). Returns
    the B5 rows and the build-shape rows."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.benchmark import make_dataset

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(22)
    b5 = []
    for b, c, m, n_rows, cells in B5_PQ_CELL_SHAPES:
        tables = torch.rand((b, m, 256), generator=g, device=dev) * 40.0
        codes = torch.randint(0, 256, (b, c, m), generator=g, device=dev, dtype=torch.uint8)
        shape = {"rows": n_rows, "cells": cells}
        b5.append({**shape, **b5_row(tables, codes)})
        code_table = torch.randint(0, 256, (n_rows, m), generator=g, device=dev,
                                   dtype=torch.uint8)
        ids = torch.randint(0, n_rows, (b, c), generator=g, device=dev)
        aux = {"point_cell": torch.randint(0, cells, (n_rows,), generator=g, device=dev,
                                           dtype=torch.int32),
               "point_bias": torch.rand((n_rows,), generator=g, device=dev) * 100.0,
               "cell_tables": torch.rand((b, cells), generator=g, device=dev) * -50.0}
        for a in ({}, aux):
            b5.append({**shape, **b5_ids_row(tables, code_table, ids, a)})
        del code_table, aux
    for row in b5:
        emit({"phase": "kernels", "kernel": "B5", "shape": "PQ-guided cell round", "card": smi,
              **row})
    for row in rowscan_rows(ROWSCAN_D100, torch.Generator(device="cpu").manual_seed(3), []):
        emit({"phase": "kernels", "card": smi, **row})
    pts, _ = make_dataset(n, PQ_CELL_D, 1, seed=42, n_clusters=1200)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    build = phase_build_shape_kernels(pts, smi)
    del pts
    torch.cuda.empty_cache()
    return {"b5": b5, "build_shape": build}


def b4_timed(vals, kk: int) -> dict:
    """B4, its plain version and `torch.topk` on one block. At the serving
    shape B4 runs for about 10 us, less than the host takes to launch it, so
    `ms`, `plain_ms` and `library_ms` are device times (`device_ms`, as for
    B5; `timed_by` says which timer gave them); the `*_launch_to_launch`
    keys are CUDA events around back-to-back calls."""
    import torch

    from diskrag_tpu_torch.ops import flat_scan as fs

    calls = {"ms": lambda: fs.topk_lanes(vals, kk),
             "plain_ms": lambda: fs.topk_lanes_ref(vals, kk),
             "library_ms": lambda: torch.topk(vals, kk, dim=1)}
    out = {}
    for key, fn in calls.items():
        out[key], out["timed_by"] = device_ms(fn, 20)
        out[f"{key}_launch_to_launch"] = cuda_ms(fn, 50)
    out["device_ms"] = out["ms"] if out["timed_by"] == "profiler" else None
    return out


def phase_build_shape_kernels(pts, smi: str, *, metric: str = "l2") -> dict:
    """B1 and B4 at the shapes the graph build's kNN pass hands them: a
    block of 4096 database rows as queries over the whole table at
    NB = 4096, then the cut to kk = 4 * 65 = 260 lanes. The operands are
    made as `exact_knn` and `flat_search_fused` make them: for cosine the
    table is built from the rows normalized with `rsqrt(norms + 1e-12)`,
    the queries are normalized again before they are quantized, and B1
    runs its norm-free form. Both bit-identical to their plain versions on
    those operands; timed and bounded."""
    import torch

    from diskrag_tpu_torch.ops import flat_scan as fs

    dev = torch.device("cuda", 0)
    pts_d = torch.as_tensor(pts, device=dev)
    l2 = metric == "l2"
    src = pts_d if l2 else pts_d * torch.rsqrt(torch.sum(pts_d * pts_d, -1) + 1e-12)[:, None]
    codes, block, _, n = fs.build_rowscan_table(src, metric=metric)
    codes = fs.align_code_rows(codes)
    del src
    b, nb, kk = 4096, 4096, 260
    q = pts_d[:b]
    if not l2:
        q = q / (torch.sqrt(torch.sum(q * q, -1, keepdim=True)) + 1e-12)
    qc, qs = fs.quantize_int8(q)
    args, kw = (qc, codes, block), dict(n_buckets=nb, use_norms=l2, q_scales=qs, n_valid=n)
    vals, row = compare_b1(*args, **kw)
    ops = fs._scan_operands(*args, db_scales=None, **kw)
    lk, lr = fs.topk_lanes(vals, kk), fs.topk_lanes_ref(vals, kk)
    torch.cuda.synchronize()
    require(bool(torch.equal(lk, lr)), f"B4 differs at NB={nb} kk={kk} ({metric})")
    b1_bound, b1_by = b1_bound_ms(b, n, pts.shape[1], nb)
    b4_bound, b4_by = b4_bound_ms(b, nb, kk)
    out = {
        "B1": {"b": b, "n": n, "nb": nb, "metric": metric, "use_norms": l2,
               "match": row["match"], "max_abs_err": row["max_abs_err"],
               "ms": cuda_ms(lambda: fs.scan_bucketed_topk(*args, **kw), 10),
               "device_ms": kernel_device_ms(lambda: fs.scan_bucketed_topk(*args, **kw), 5),
               "plain_ms": cuda_ms(lambda: fs.scan_bucketed_topk_ref(*ops), 1),
               "library_ms": None, "bound_ms": b1_bound, "bound_by": b1_by,
               "plan": str(fs.plan_rowscan(b, nb, codes.shape[0], codes.shape[1],
                                           torch.cuda.get_device_properties(0).multi_processor_count))},
        "B4": {"b": b, "nb": nb, "kk": kk, "match": "bit-identical",
               "max_abs_err": float((lk - lr).abs().max()), **b4_timed(vals, kk),
               "bound_ms": b4_bound, "bound_by": b4_by, "plan": str(fs.plan_cut(nb, kk))},
    }
    emit({"phase": "kernels", "case": f"graph-build shapes ({metric}, {n} rows)", "card": smi,
          **out})
    del pts_d, codes, vals
    torch.cuda.empty_cache()
    return out


def phase_device() -> dict:
    import torch

    from diskrag_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    import threading

    from diskrag_tpu_torch.native import load_library

    t0 = time.perf_counter()
    # the host tier's record reader (host C++) builds beside the nvcc runs
    reader_build: dict = {}

    def build_reader():
        try:
            load_library()
            reader_build["seconds"] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — re-raised below, in this thread
            reader_build["error"] = e

    th = threading.Thread(target=build_reader)
    th.start()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    th.join()
    if "error" in reader_build:
        raise reader_build["error"]
    ptxas = {
        stem: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "wgmma" in ln]
        for stem, log in _build.build_logs.items() if not stem.startswith("native/")
    }
    emit({
        "phase": "device", "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "build_seconds": round(build_s, 3),
        "kernels_built": sorted(paths), "ptxas": ptxas,
        "record_reader": {"library": _build.host_lib_path(_build.NATIVE / "io_native.cpp").name,
                          "built_in_seconds": round(reader_build["seconds"], 3)},
        "sass_b1_int8": wgmma_sass(paths["flat_scan"], "scan_i8_wgmma", "IDP4A"),
        "sass_b1_bf16": wgmma_sass(paths["flat_scan"], "scan_bf16_wgmma", "FFMA", want="HGMMA",
                                   absent="scan_partial"),
        "sass_packed_wgmma": {stem: wgmma_sass(paths[stem], "packed_wgmma_partial", "IMMA")
                              for stem in ("packed_scan", "hier_scan")},
        "sass_b6_pingpong": wgmma_sass(paths["hier_scan"], "pingpong_wgmma_partial", "IMMA"),
        "sass_m1": wgmma_sass(paths["mm_probe"], "mm_probe_kernel", "IMMA"),
        "b6_registers": b6_registers(),
    })
    return {"smi": smi}


def b6_registers() -> dict:
    """The registers a thread that ptxas gave each instantiation of B6's
    partial kernel (rows of 16-64, 80-128 and 144-192 bytes) beside those
    its `setmaxnreg` split assumes at launch: they must be equal, or the
    consumers' `setmaxnreg.inc` would wait forever (the launcher refuses
    such a build; this shows it is not one)."""
    from diskrag_tpu_torch.kernels import _build

    lib = _build.load("hier_scan")
    want = lib.hier_scan_pipelined_launch_regs()
    got = {rb: lib.hier_scan_pipelined_kernel_regs(rb) for rb in (64, 128, 192)}
    require(all(r == want for r in got.values()),
            f"B6's partial kernel has {got} registers a thread, its split assumes {want}")
    return {"launch_regs": want, "kernel_regs_by_row_bytes": got}


def wgmma_sass(lib: pathlib.Path, kernel: str, other: str, want: str = "IGMMA",
               absent: str | None = None) -> dict:
    """`want` (IGMMA: integer wgmma, HGMMA: bf16 wgmma) and `other`
    instructions in each instantiation of `kernel` in a built library
    (`cuobjdump -sass`, beside nvcc): its products must run on the tensor
    cores through wgmma alone — B1's int8 kernel none on __dp4a (IDP4A),
    its bf16 kernel none on scalar FMAs (FFMA), the partial kernels of B2 /
    B3, B6 and M1 none on mma.sync (IMMA). With `absent`, no function of
    that name may remain in the library (B1's retired fmaf kernel)."""
    from diskrag_tpu_torch.kernels import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {"cuobjdump": "not found"}
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts: dict = {}
    names = []
    for section in sass.split("Function : ")[1:]:
        name = section.split("\n", 1)[0].strip()
        names.append(name)
        if kernel in name:
            key = name[name.index(kernel):][:len(kernel) + 17]  # the template arguments
            counts[key] = {op: section.count(op) for op in (want, other)}
    require(bool(counts) and all(c[want] > 0 and c[other] == 0 for c in counts.values()),
            f"{kernel} in {lib.name} is not on wgmma alone: {counts}")
    if absent is not None:
        require(not any(absent in n for n in names), f"{absent} is still in {lib.name}")
        counts[f"{absent} functions"] = 0
    return counts


def _scan_inputs(pts_dev, q_dev, metric: str):
    """(query codes, q_scales, table codes, norm block, n, scan source,
    float queries) as the main path builds them (`FlatIndex` +
    `flat_search_fused`)."""
    import torch

    from diskrag_tpu_torch.ops.flat_scan import build_rowscan_table, quantize_int8

    if metric == "cosine":
        src = pts_dev * torch.rsqrt(torch.sum(pts_dev * pts_dev, -1) + 1e-12)[:, None]
        qf = q_dev / (torch.sqrt(torch.sum(q_dev * q_dev, -1, keepdim=True)) + 1e-12)
    else:
        src, qf = pts_dev, q_dev
    codes, block, _, n = build_rowscan_table(src, metric=metric)
    qc, qs = quantize_int8(qf)
    return qc, qs, codes, block, n, src, qf


def compare_b1(queries, db, db_norms, *, n_buckets, use_norms, q_scales=None,
               db_scales=None, n_valid=None):
    """B1's public wrapper on card tensors against the plain version on
    the operands the wrapper builds from the same arguments (NB shrink,
    bf16 query doubling, norm-block stacking). int8: vals and ids must be
    bit-identical. bf16 (products exact in f32, summed in another order
    than the plain version's f32 GEMM): vals within 1e-5 of the block's
    largest |score|, ids equal except where two segments tie within that
    tolerance. Returns (kernel vals, the row of the kernels phase)."""
    import torch

    from diskrag_tpu_torch.ops import flat_scan as fs

    kw = dict(n_buckets=n_buckets, use_norms=use_norms, q_scales=q_scales,
              db_scales=db_scales, n_valid=n_valid)
    v_k, i_k = fs.scan_bucketed_topk(queries, db, db_norms, **kw)
    ops = fs._scan_operands(queries, db, db_norms, **kw)
    v_r, i_r = fs.scan_bucketed_topk_ref(*ops)
    torch.cuda.synchronize()
    fin = torch.isfinite(v_r)
    err = float((v_k[fin] - v_r[fin]).abs().max()) if bool(fin.any()) else 0.0
    bad = i_k != i_r
    what = (f"B1 {queries.dtype} n={ops[6]} d={queries.shape[1]} nb={ops[3]} "
            f"norms={use_norms} table={n_valid is not None}")
    row = {"kernel": "B1", "precision": str(queries.dtype).split(".")[-1],
           "n": ops[6], "d": queries.shape[1], "nb": ops[3], "use_norms": use_norms,
           "table": n_valid is not None, "max_abs_err": err}
    if queries.dtype == torch.int8:
        require(bool(torch.equal(v_k, v_r)) and not bool(bad.any()),
                f"{what} not bit-identical: max_abs_err={err} id_mismatches={int(bad.sum())}")
        row["match"] = "bit-identical"
    else:
        tol = 1e-5 * float(v_r[fin].abs().max())
        require(err <= tol and bool(torch.equal(fin, torch.isfinite(v_k))),
                f"{what} vals off by {err} > {tol}")
        near = (v_k - v_r).abs() <= tol
        require(bool((~bad | near).all()), f"{what}: id differs away from a near-tie")
        row.update(match=f"vals within {tol:.3g}; ids except near-ties",
                   id_mismatches=int(bad.sum()))
    return v_k, row


def rowscan_rows(cases, g, b4_cases: list) -> list[dict]:
    """B1 int8 and bf16 against their plain versions on random rows at
    each (rows, D, B, NBs) of `cases`, all three metrics; each l2 int8
    block goes to `b4_cases` with the cut B4 takes at its NB."""
    import torch

    dev = torch.device("cuda", 0)
    rows = []
    for n_pts, d, b, nbs in cases:
        pts = torch.randn((n_pts, d), generator=g).to(dev)
        q_d = pts[:b] + 0.05 * torch.randn((b, d), generator=g).to(dev)
        for metric in ("l2", "cosine", "dot"):
            l2 = metric == "l2"
            qc, qs, codes, block, n, src, qf = _scan_inputs(pts, q_d, metric)
            for nb in nbs:
                vals, row = compare_b1(qc, codes, block, n_buckets=nb, use_norms=l2,
                                       q_scales=qs, n_valid=n)
                rows.append({"metric": metric, "b": b, **row})
                if l2:
                    b4_cases.append((vals, min(nb, 260 if nb >= 4096 else 40)))
                _, row = compare_b1(qf.to(torch.bfloat16), src.to(torch.bfloat16),
                                    torch.sum(src * src, -1), n_buckets=nb, use_norms=l2)
                rows.append({"metric": metric, "b": b, **row})
        del pts, q_d
    return rows


def phase_kernels() -> dict:
    """Each kernel's public wrapper against its plain version on the card,
    at the shapes of the comparison set (200k x 128, B = 1000, NB = 512
    and 8192, both int8 table forms and bf16, all three metrics), at a
    tiny one (300 x 36: NB shrinks to 256, rows are zero-padded to 16
    bytes), at `ROWSCAN_CASES` (int8, all three metrics) and at NB = 32768;
    B4 on the l2 blocks, on NB = 32768 with kk = 1316 and kk > NB, and on a
    block of ties, signed zeros and -inf rows."""
    import torch

    from diskrag_tpu_torch.benchmark import make_dataset
    from diskrag_tpu_torch.ops import flat_scan as fs

    dev = torch.device("cuda", 0)
    rows = []
    b4_cases = []
    for n_pts, d in ((CMP_N, MAIN_D), (300, 36)):
        pts, q = make_dataset(n_pts, d, MAIN_B, seed=7)
        pts_d = torch.as_tensor(pts, device=dev)
        q_d = torch.as_tensor(q, device=dev)
        for metric in ("l2", "cosine", "dot"):
            l2 = metric == "l2"
            qc, qs, codes, block, n, src, qf = _scan_inputs(pts_d, q_d, metric)
            for nb in (512, 8192):
                vals, row = compare_b1(qc, codes, block, n_buckets=nb, use_norms=l2,
                                       q_scales=qs, n_valid=n)
                rows.append({"metric": metric, **row})
                if l2 and n_pts == CMP_N:
                    b4_cases.append((vals, 40 if nb == 512 else 400))
            if l2:  # the unpadded int8 form: the wrapper stacks and doubles the scales
                _, db_scales = fs.quantize_int8(src)
                _, row = compare_b1(qc, codes[:n], torch.sum(src * src, -1), n_buckets=512,
                                    use_norms=True, q_scales=qs, db_scales=db_scales)
                rows.append({"metric": metric, **row})
            for nb in (512, 8192):
                _, row = compare_b1(qf.to(torch.bfloat16), src.to(torch.bfloat16),
                                    torch.sum(src * src, -1), n_buckets=nb, use_norms=l2)
                rows.append({"metric": metric, **row})
        del pts_d, q_d
    # B1 at the other row widths, batch sizes and NB the wrappers pass
    # (ragged n; the wide rows at a modest n): int8, and bf16 on the same
    # rows (D = 36 zero-padded to 80-byte rows, D = 1536 streaming its query
    # boxes); B4 cut from each int8 block
    g = torch.Generator(device="cpu").manual_seed(3)
    rows += rowscan_rows(ROWSCAN_CASES, g, b4_cases)
    # NB = 32768 (the widening rule's ceiling) from a real scan: kk = 1316
    # (k = 329) and kk > NB (the 16-bit sort)
    pts, q = make_dataset(CMP_N, MAIN_D, 64, seed=7)
    qc, qs, codes, block, n, _, _ = _scan_inputs(torch.as_tensor(pts, device=dev),
                                                 torch.as_tensor(q, device=dev), "l2")
    wide, row = compare_b1(qc, codes, block, n_buckets=32768, use_norms=True, q_scales=qs,
                           n_valid=n)
    rows.append({"metric": "l2", "b": 64, **row})
    b4_cases += [(wide, 1316), (wide[:8], 40000)]
    # a block built for ties, signed zeros and exhaustion
    ties = torch.randint(-2, 3, (64, 512), generator=g).to(torch.float32)
    ties[ties == 0] = -0.0
    ties[:, ::7] = 0.0
    ties[::3, 100:] = float("-inf")
    ties[5] = float("-inf")
    b4_cases.append((ties.to(dev), 40))
    for vals, kk in b4_cases:
        lk = fs.topk_lanes(vals, kk)
        lr = fs.topk_lanes_ref(vals, kk)
        torch.cuda.synchronize()
        require(bool(torch.equal(lk, lr)), f"B4 differs at NB={vals.shape[1]} kk={kk}")
        rows.append({"kernel": "B4", "b": vals.shape[0], "nb": vals.shape[1], "kk": kk,
                     "match": "bit-identical", "plan": str(fs.plan_cut(vals.shape[1], kk)),
                     "sentinels": int((lr == vals.shape[1]).sum())})
    for r in rows:
        emit({"phase": "kernels", **r})
    del b4_cases
    torch.cuda.empty_cache()
    return {}


def compare_packed(kind, qc, qs, db, norms, scale, *, n_buckets, n_valid, cut_kk=None,
                   db_tile=2048, query_block=1024):
    """A packed fold's public wrapper (`kind` "B2", "B3" or "B6") on card
    tensors against its plain version on the operands the wrapper builds
    from the same arguments (NB, the pad rows scanned, nf, 1 / q_scale).
    After one f32 product the folds are integer arithmetic, so scores and
    ids (or the fused cut's ids) must be bit-identical. Returns the
    wrapper's (scores, ids) and what was measured: the count of ids that
    differ and, where the wrapper returns scores, their largest absolute
    difference over the finite entries (None for a fused cut)."""
    import torch

    from diskrag_tpu_torch.ops import flat_scan as fs

    kw = dict(n_buckets=n_buckets, query_block=query_block, db_tile=db_tile,
              n_valid=n_valid, cut_kk=cut_kk)
    args = (qc, qs, db, norms, scale)
    if kind == "B2":
        out = fs.scan_bucketed_topk_packed(*args, **kw)
        ops = fs._packed_fold_operands(*args, **kw)
        ref = fs.scan_bucketed_topk_packed_ref(*ops)
    else:
        pipe = kind == "B6"
        out = fs.scan_bucketed_topk_hier(*args, pipelined=pipe, **kw)
        ops = fs._hier_fold_operands(*args, pipelined=pipe, **kw)
        ref = fs.scan_bucketed_topk_hier_ref(*ops)
    torch.cuda.synchronize()
    what = (f"{kind} n={ops[6]} rows={db.shape[0]} d={qc.shape[1]} nb={ops[4]} "
            f"n_scan={ops[5]} table={n_valid is not None} cut={cut_kk}")
    measured = {"id_mismatches": int((out[1] != ref[1]).sum()), "max_abs_err": None}
    require(measured["id_mismatches"] == 0,
            f"{what}: ids differ in {measured['id_mismatches']} places")
    if cut_kk is None:
        fin = torch.isfinite(ref[0])
        measured["max_abs_err"] = (float((out[0][fin] - ref[0][fin]).abs().max())
                                   if bool(fin.any()) else 0.0)
        require(bool(torch.equal(out[0], ref[0])),
                f"{what}: scores differ, max_abs_err={measured['max_abs_err']}")
    else:
        require(out[0] is None and out[1].shape == (qc.shape[0], cut_kk), f"{what}: cut shape")
    return out, measured


def packed_inputs(pts_d, q_d, metric: str):
    """Both contracts of the packed wrappers for one dataset, as the main
    path builds them (`FlatIndex` + `flat_search_fused`): query codes and
    scale, then (codes, norms or nf, scale, n_valid) for the pre-padded
    table and for the unpadded rows."""
    import torch

    from diskrag_tpu_torch.ops import flat_scan as fs

    if metric == "cosine":
        src = pts_d * torch.rsqrt(torch.sum(pts_d * pts_d, -1) + 1e-12)[:, None]
        qf = q_d / (torch.linalg.vector_norm(q_d, dim=-1, keepdim=True) + 1e-12)
    else:
        src, qf = pts_d, q_d
    qc, qs = fs.quantize_int8_global(qf)
    codes, nf, scale, n = fs.build_packed_scan_table(src)
    table = (codes, nf, scale, n)
    unpadded = (codes[:n], torch.sum(src * src, -1), scale, None)
    return qc, qs, table, unpadded


def headline_b3_cases(pts_d, q_d, metric: str) -> dict:
    """B3 at the bench headline's shape: `BIG_B` queries (the batch tiled,
    one global query scale over all of them) over the 200k table, at the
    geometry `plan_packed_search` gives that batch (NB 512), with the cut
    fused at kk `BIG_RW` and without a cut, both contracts, bit for bit
    against its plain version."""
    import torch

    from diskrag_tpu_torch.ops import flat_scan as fs

    qb = q_d[torch.arange(BIG_B, device=q_d.device) % q_d.shape[0]]
    qc, qs, table, unpadded = packed_inputs(pts_d, qb, metric)
    plan = fs.plan_packed_search(table[0].shape[0], table[3], qc.shape[1], BIG_B, 512, BIG_RW)
    require((plan.fold, plan.nb, plan.cut_kk) == ("hier", 512, BIG_RW),
            f"the headline shape routed to {plan}")
    cases, worst = 0, 0
    for db, norms, scale, n_valid in (table, unpadded):
        for cut in (BIG_RW, None):
            _, measured = compare_packed("B3", qc, qs, db, norms, scale, n_buckets=512,
                                         n_valid=n_valid, cut_kk=cut, db_tile=plan.db_tile,
                                         query_block=plan.query_block)
            worst = max(worst, measured["id_mismatches"])
            cases += 1
    return {"case": f"bench headline: B3 at {BIG_B} x {pts_d.shape[0]}", "b": BIG_B,
            "nb": plan.nb, "n_scan": plan.n_scan, "query_block": plan.query_block,
            "db_tile": plan.db_tile, "cut_kk": [BIG_RW, None],
            "contracts": ["table", "unpadded"], "comparisons": cases,
            "id_mismatches": worst, "match": "bit-identical"}


# B2 / B3 at every row width class the partial kernel takes (2, 4 or 6
# k-steps: one 128-byte K box at 16 to 64 bytes, two at 144 and 192) and at
# batches whose last 64-query block is nearly empty (1, 37, 65, 193) or full,
# over 70,000 rows: at NB 128 B3 walks 547 segments, two whole super-tiles
# and a ragged third; B2 widens NB to 512 (137 or 144 segments)
PACKED_WIDTHS = (16, 48, 64, 144, 192)
PACKED_BATCHES = (1, 37, 64, 65, 193, 1000, 4096)
PACKED_ROWS = 70_000


def phase_packed_kernels() -> None:
    """B2, B3 and B6 (and both fused cuts) against their plain versions on
    the card: 200k x 128 and a ragged 5000 x 44 (rows zero-padded to 16
    bytes, real pad rows), l2 and cosine, both contracts, NB 512 and 8192,
    no cut and cuts of 20 and 40; B6 also against B3; a block built for
    ties and exhaustion (every row twice; fewer valid rows than kk); then
    B2 and B3 at `PACKED_WIDTHS` x `PACKED_BATCHES` over `PACKED_ROWS` rows
    (a seventh of them repeated: exact ties), both contracts, with and
    without a cut of 40."""
    import torch

    from diskrag_tpu_torch.benchmark import make_dataset

    dev = torch.device("cuda", 0)

    def all_kinds(qc, qs, contract, nbs, cuts):
        db, norms, scale, n_valid = contract
        cases = 0
        for nb in nbs:
            for cut in cuts:
                for kind in ("B2", "B3"):
                    compare_packed(kind, qc, qs, db, norms, scale, n_buckets=nb,
                                   n_valid=n_valid, cut_kk=cut)
                    cases += 1
            # B6 narrows the reference's tile to 2 * NB, which can change the
            # pad rows scanned: B3 gets the same tile for the comparison
            tile = min(2048, 2 * nb)
            b6, _ = compare_packed("B6", qc, qs, db, norms, scale, n_buckets=nb,
                                   n_valid=n_valid, db_tile=tile)
            b3, _ = compare_packed("B3", qc, qs, db, norms, scale, n_buckets=nb,
                                   n_valid=n_valid, db_tile=tile)
            require(bool(torch.equal(b6[0], b3[0]) and torch.equal(b6[1], b3[1])),
                    f"B6 differs from B3 at nb={nb}")
            cases += 2
        return cases

    for n_pts, d in ((CMP_N, MAIN_D), (5000, 44)):
        pts, q = make_dataset(n_pts, d, MAIN_B, seed=7)
        pts_d = torch.as_tensor(pts, device=dev)
        q_d = torch.as_tensor(q, device=dev)
        for metric in ("l2", "cosine"):
            qc, qs, table, unpadded = packed_inputs(pts_d, q_d, metric)
            cases = sum(all_kinds(qc, qs, c, (512, 8192), (None, 20, 40))
                        for c in (table, unpadded))
            emit({"phase": "kernels", "kernel": "B2+B3+B6", "n": n_pts, "d": d,
                  "metric": metric, "contracts": ["table", "unpadded"], "nb": [512, 8192],
                  "cut_kk": [None, 20, 40], "comparisons": cases, "match": "bit-identical"})
            if n_pts == CMP_N:
                emit({"phase": "kernels", "kernel": "B2+B3+B6", "metric": metric,
                      **headline_b3_cases(pts_d, q_d, metric)})
        del pts_d, q_d
    # ties and exhaustion: every row twice (equal packed scores in two
    # segments), and a table with 30 valid rows under a cut of 40
    pts, q = make_dataset(3000, 64, 64, seed=5)
    pts[1500:] = pts[:1500]
    cases = 0
    for rows in (pts, pts[:30]):
        qc, qs, table, unpadded = packed_inputs(
            torch.as_tensor(rows, device=dev), torch.as_tensor(q, device=dev), "l2")
        cases += sum(all_kinds(qc, qs, c, (128, 512), (None, 40)) for c in (table, unpadded))
    emit({"phase": "kernels", "kernel": "B2+B3+B6", "case": "duplicate rows; 30 valid rows, kk 40",
          "comparisons": cases, "match": "bit-identical"})
    g = torch.Generator(device="cpu").manual_seed(17)
    for d in PACKED_WIDTHS:
        pts = torch.randn((PACKED_ROWS, d), generator=g).to(dev)
        pts[40_000:50_000] = pts[:10_000]
        cases = 0
        for b in PACKED_BATCHES:
            pick = torch.randint(0, PACKED_ROWS, (b,), generator=g).to(dev)
            q_d = pts[pick] + 0.05 * torch.randn((b, d), generator=g).to(dev)
            qc, qs, table, unpadded = packed_inputs(pts, q_d, "l2")
            for db, norms, scale, n_valid in (table, unpadded):
                for cut in (None, 40):
                    for kind in ("B2", "B3"):
                        compare_packed(kind, qc, qs, db, norms, scale, n_buckets=128,
                                       n_valid=n_valid, cut_kk=cut)
                        cases += 1
                # B6 against its plain version and against B3 at its tile
                b6, _ = compare_packed("B6", qc, qs, db, norms, scale, n_buckets=128,
                                       n_valid=n_valid, db_tile=256)
                b3, _ = compare_packed("B3", qc, qs, db, norms, scale, n_buckets=128,
                                       n_valid=n_valid, db_tile=256)
                require(bool(torch.equal(b6[0], b3[0]) and torch.equal(b6[1], b3[1])),
                        f"B6 differs from B3 at row width {d}, b={b}")
                cases += 2
        emit({"phase": "kernels", "kernel": "B2+B3+B6", "n": PACKED_ROWS, "row_bytes": d,
              "b": list(PACKED_BATCHES), "contracts": ["table", "unpadded"], "nb": 128,
              "cut_kk": [None, 40], "b6": "no cut, against B3 at db_tile 256",
              "comparisons": cases, "match": "bit-identical"})
        del pts
    torch.cuda.empty_cache()


def profile_batch(engine, q, steps: int = 3, path: str = "flat-1M-int8",
                  l_search: int | None = None, watch: tuple[str, ...] = ()) -> dict:
    """Device time by kernel name per `search_batch` (torch.profiler,
    CUPTI, through `profiled`, which tolerates a few dropped events and
    retries a window that lost many) and the device's idle share of the
    profiled host time. Null figures carry the reason."""
    return profile_calls(lambda: engine.search_batch(q, k=MAIN_K, l_search=l_search), steps,
                         path, watch)


def profile_calls(step_fn, steps: int, path: str, watch: tuple[str, ...] = ()) -> dict:
    """`profile_batch` for any call that serves one batch."""
    by_name, per_batch, recorded, wall, windows, reason = profiled(
        step_fn, steps, what=f"profile {path}")
    by_name = by_name or {}
    wall_ms = sum(wall) / max(len(wall), 1)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    watched = {w: sum(v for k, v in by_name.items() if w in k) for w in watch}
    return {
        **({"device_ms_watched_per_batch": watched,
            "device_launches_per_batch": per_batch} if watch else {}),
        "phase": "profile", "path": path, "batches": steps, "profiler_windows": windows,
        "profiler_events_recorded_share": recorded,
        "wall_ms_per_batch": wall_ms,
        "device_busy_ms_per_batch": busy if by_name else None,
        "device_idle_share": (1.0 - busy / wall_ms) if by_name else None,
        **({"device_null_reason": reason} if reason else {}),
        "device_ms_by_kernel_per_batch": [[k[:90], v] for k, v in top],
    }


def make_collection(base, name: str, pts):
    """Collection `name` under `base` holding `pts` (its vectors.npy and
    info, no index yet); returns its index directory."""
    import numpy as np

    from diskrag_tpu_torch.data.collection import CollectionManager
    from diskrag_tpu_torch.data.config import CollectionInfo

    mgr = CollectionManager(base)
    (base / name).mkdir(parents=True)
    np.save(mgr.get_vectors_path(name), pts)
    mgr.save_collection_info(CollectionInfo(
        name=name, config={}, dimension=pts.shape[1], num_vectors=len(pts),
        created_at="", updated_at="", source_files=[],
    ))
    return mgr.get_index_dir(name)


def serve(base, name: str, pts, precision: str | None):
    """Persist `pts` as collection `name`, build its index — a flat one of
    the given precision, or with `precision=None` whatever `index_type=
    "auto"` and the defaults give, with the host tier's record file
    (`write_compat`) — and load it into a `SearchEngine` on the card: the
    entry points a user's `index` and `search` commands go through.
    Returns (engine, meta)."""
    from diskrag_tpu_torch.build_index import build_index_from_vectors
    from diskrag_tpu_torch.engine import SearchEngine

    index_dir = make_collection(base, name, pts)
    if precision is None:
        meta = build_index_from_vectors(pts, index_dir, index_type="auto", write_compat=True,
                                        device="cuda")
    else:
        meta = build_index_from_vectors(pts, index_dir, index_type="flat",
                                        flat_precision=precision, device="cuda")
        require(meta["index_type"] == "flat" and meta["flat_precision"] == precision,
                "build did not make the requested flat index")
    engine = SearchEngine(name, base_dir=str(base), device="cuda")
    require(bool(engine.diagnostics and engine.diagnostics["passed"]),
            f"startup diagnostic failed: {engine.diagnostics}")
    return engine, meta


def build_peak_bytes(*stage_dicts) -> int:
    """The peak device bytes of a build and what followed it: the largest
    of its stages' peaks (`build_vamana_knn` records each stage's and
    resets the allocator's peak at each stage's start) and the allocator's
    peak since the last of those resets."""
    import torch

    peaks = [v for st in stage_dicts for v in st.get("peak_device_bytes", {}).values()]
    return max([*peaks, torch.cuda.max_memory_allocated()])


def searches_on_the_card(n: int) -> dict:
    """The launches of n exact searches on the card: G2 seeds each and G1
    runs its rounds, one launch each a search."""
    return {"G2": n, "G1": n}


def reset_counts() -> None:
    from diskrag_tpu_torch.kernels.launches import reset_launch_counts

    reset_launch_counts()


def read_counts() -> dict:
    from diskrag_tpu_torch.kernels.launches import launch_counts

    return launch_counts()


def drive(engine, q, reps: int, l_search: int | None = None):
    """`reps` timed `search_batch` calls with every launch count set to 0
    just before and read just after: (dists, ids, stats of every call,
    seconds per batch, launches by kernel)."""
    reset_counts()
    batch_s, all_stats = [], []
    for _ in range(reps):
        t = time.perf_counter()
        dists, ids, stats = engine.search_batch(q, k=MAIN_K, l_search=l_search)
        batch_s.append(time.perf_counter() - t)
        all_stats.append(stats)
    return dists, ids, all_stats, batch_s, read_counts()


# the JAX serving bench's pipelined shape (`benchmarks/serving_bench.py::
# measure_pipelined_qps`): batches of 512 text queries, 16 of them, 8 in flight
PIPE_B, PIPE_BATCHES, PIPE_IN_FLIGHT = 512, 16, 8


def event_wait_releases_gil() -> dict:
    """`torch.cuda.Event.synchronize()` on a worker thread, behind ~50 ms
    of device sleep, while the main thread counts loop turns: a wait that
    held the GIL would leave the main thread no turn until it ended."""
    import threading

    import torch

    torch.cuda.synchronize()
    event = torch.cuda.Event()
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's ~2 GHz
    event.record()
    done = threading.Event()
    waiter = threading.Thread(target=lambda: (event.synchronize(), done.set()))
    t = time.perf_counter()
    waiter.start()
    turns = 0
    while not done.is_set():
        turns += 1
    wait_ms = (time.perf_counter() - t) * 1e3
    waiter.join()
    require(wait_ms >= 10 and turns >= 10_000,
            f"Event.synchronize held the GIL: {turns} main-thread turns in {wait_ms:.1f} ms")
    return {"event_wait_ms": wait_ms, "main_thread_turns_during_wait": turns}


def _pipe_texts(q, n_batches: int) -> tuple[list, dict]:
    """`n_batches` batches of PIPE_B text queries and the lookup table that
    embeds them as the cell's own query vectors, in turn (the JAX serving
    bench's embedder)."""
    texts = [[f"q{j * PIPE_B + i}" for i in range(PIPE_B)] for j in range(n_batches)]
    return texts, {t: q[(j * PIPE_B + i) % len(q)]
                   for j, batch in enumerate(texts) for i, t in enumerate(batch)}


def _result_lists(out: dict):
    """(ids, distances), one list a query, of a `search_many`-shaped
    result: compared with ==, the distances as exact floats."""
    ids = [[r["metadata"]["vector_index"] for r in row] for row in out["results"]]
    dists = [[r["distance"] for r in row] for row in out["results"]]
    return ids, dists


def pipelined_row(smi: str, engine, q, cell: str, *, expect: dict, l_search: int | None = None,
                  n_batches: int = PIPE_BATCHES, passes: int = 2, witness_gate: bool = False,
                  profile_batches: int = 4) -> dict:
    """`SearchEngine.search_pipelined` over `n_batches` batches of PIPE_B
    text queries with PIPE_IN_FLIGHT in flight, beside `search_many` on the
    same batches one after the other, in `passes` turns of each (search_many,
    pipelined, pipelined, search_many: Python's cyclic collector stops a
    pass for a while at times, so each side's best pass is taken); the
    launch counts set to 0 just before each pass and read just after.
    Gates: every batch's ids and distances equal (as exact values) to
    `search_many`'s, the same search type, the same launches in every pass,
    and the ones `expect` names ({kernel: "batches" | "rounds" | launches a
    batch}; every other kernel 0). The overlap witness: for each batch after the first,
    whether the previous batch's event was still pending when this batch's
    dispatch began (its queries already uploaded: a pageable upload would
    have waited for that batch) and when it returned; the first is gated
    with `witness_gate`. Prints QPS and ms a batch of both, the text join's,
    the embedding's and the dispatch's host ms, the row's seconds, and the
    device idle share of a profiled pipelined window of `profile_batches`
    batches (0: not profiled)."""
    import numpy as np

    t_row = time.perf_counter()
    texts, lut = _pipe_texts(q, n_batches)
    kw = dict(k=MAIN_K, embedding_fn=lut.__getitem__, l_search=l_search)
    engine.search_pipelined(texts[:2], max_in_flight=PIPE_IN_FLIGHT, **kw)  # warm-up
    pending: list = []  # (previous event pending at this dispatch's start, at its end)
    dispatch_ms: list = []
    last: list = []
    dispatch = engine._dispatch_search

    def witnessed(*args, **kwargs):
        prev = last[0][3] if last else None
        at_start = prev is not None and not prev.query()
        t = time.perf_counter()
        disp = dispatch(*args, **kwargs)
        dispatch_ms.append((time.perf_counter() - t) * 1e3)
        if prev is not None:
            pending.append((at_start, not prev.query()))
        last[:] = [disp]
        return disp

    def run_seq():
        return [engine.search_many(b, **kw) for b in texts]

    def run_piped():
        last.clear()
        engine._dispatch_search = witnessed
        try:
            return engine.search_pipelined(texts, max_in_flight=PIPE_IN_FLIGHT, **kw)
        finally:
            del engine._dispatch_search
            last.clear()

    runs = {"seq": [], "piped": []}
    order = ["seq", "piped"] + ["piped", "seq"] * (passes > 1)
    for which in order:
        reset_counts()
        t = time.perf_counter()
        outs = run_seq() if which == "seq" else run_piped()
        runs[which].append((outs, time.perf_counter() - t, read_counts()))
    seq, _, seq_launches = runs["seq"][0]
    for which, (outs, _, launches) in ((w, r) for w in runs for r in runs[w]):
        require(len(outs) == n_batches, f"{cell}: {len(outs)} results for {n_batches} batches")
        for i, (got, want) in enumerate(zip(outs, seq)):
            (gi, gd), (wi, wd) = _result_lists(got), _result_lists(want)
            require(len(gi) == PIPE_B and all(len(r) == MAIN_K for r in gi)
                    and gi == wi and gd == wd,
                    f"{cell}: {which} batch {i} differs from search_many's first pass")
            require(got["stats"]["search_type"] == want["stats"]["search_type"],
                    f"{cell}: {which} batch {i} served as {got['stats']['search_type']}, "
                    f"search_many as {want['stats']['search_type']}")
        require(launches == seq_launches,
                f"{cell}: {which} pass launched {launches}, search_many's first {seq_launches}")
    rounds = sum(out["stats"].get("rounds", 0) for out in seq)
    want_launches = {kid: how * n_batches if isinstance(how, int)
                     else {"batches": n_batches, "rounds": rounds}[how]
                     for kid, how in expect.items()}
    require(all(v == want_launches.get(kid, 0) for kid, v in seq_launches.items()) and (
        not want_launches or min(want_launches.values()) > 0),
        f"{cell}: launches {seq_launches}, expected {want_launches}")
    if witness_gate:
        require(any(a for a, _ in pending),
                f"{cell}: no batch was dispatched before its predecessor finished: {pending}")

    def join_ms(out):
        tm = out["timing"]
        return (tm["total_time"] - tm["embedding_time"] - tm["search_time"]) * 1e3

    seq_s = [sec for _, sec, _ in runs["seq"]]
    pipe_s = [sec for _, sec, _ in runs["piped"]]
    piped = runs["piped"][0][0]
    n_q = PIPE_B * n_batches
    row = {
        "phase": "pipelined", "cell": cell, "batch": PIPE_B, "n_batches": n_batches,
        "max_in_flight": PIPE_IN_FLIGHT, "k": MAIN_K, "l_search": seq[0]["stats"]["L_search"],
        "search_type": seq[0]["stats"]["search_type"], "passes": passes,
        "qps_pipelined": n_q / min(pipe_s), "ms_per_batch_pipelined": min(pipe_s) / n_batches * 1e3,
        "qps_search_many": n_q / min(seq_s), "ms_per_batch_search_many": min(seq_s) / n_batches * 1e3,
        "pipelined_over_search_many": min(seq_s) / min(pipe_s),
        "ms_per_batch_every_pass": {"pipelined": [x / n_batches * 1e3 for x in pipe_s],
                                    "search_many": [x / n_batches * 1e3 for x in seq_s]},
        "text_join_ms_median_search_many": float(np.median([join_ms(o) for o in seq])),
        "text_join_ms_median_pipelined": float(np.median([join_ms(o) for o in piped])),
        "fetch_ms_median_pipelined": float(np.median([o["stats"]["fetch_time"] for o in piped])) * 1e3,
        "embed_ms_median_pipelined": float(np.median([o["timing"]["embedding_time"]
                                                      for o in piped])) * 1e3,
        "dispatch_host_ms_median_pipelined": float(np.median(dispatch_ms)),
        "ids_equal_to_search_many": "ids and distances equal, every batch of every pass",
        "launches_per_pass": seq_launches, "rounds_per_pass": rounds,
        "dispatch_began_before_previous_done": sum(a for a, _ in pending),
        "dispatch_returned_before_previous_done": sum(b for _, b in pending),
        "dispatches_witnessed": len(pending), "witness_gated": witness_gate,
    }
    if profile_batches:
        prof = profile_calls(
            lambda: engine.search_pipelined(texts[:profile_batches], max_in_flight=PIPE_IN_FLIGHT,
                                            **kw),
            1, f"{cell} pipelined ({profile_batches} batches of {PIPE_B})")
        row["profiled_batches"] = profile_batches
        row["device_idle_share_pipelined"] = prof["device_idle_share"]
        row["device_busy_ms_profiled_window"] = prof["device_busy_ms_per_batch"]
        row["wall_ms_profiled_window"] = prof["wall_ms_per_batch"]
        if prof.get("device_null_reason"):
            row["device_null_reason"] = prof["device_null_reason"]
    else:
        row["device_idle_share_pipelined"] = None
        row["device_null_reason"] = "not profiled: a window of this cell outlasts the row's time"
    row["seconds"] = time.perf_counter() - t_row
    row["card"] = smi
    emit(row)
    return row


def phase_main(smi: str, base, pts, q, gt) -> dict:
    """The per-row int8 main path at the bench size, plus B1's and B4's
    times at the shapes that path hands them."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.benchmark import recall_at_k
    from diskrag_tpu_torch.ops import flat_scan as fs

    t0 = time.perf_counter()
    engine, _ = serve(base, "bench_1m", pts, "int8")
    setup_s = time.perf_counter() - t0

    reps = 5
    dists, ids, all_stats, batch_s, launches = drive(engine, q, reps)
    stats = all_stats[-1]
    require(launches["B1"] == reps and launches["B4"] == reps,
            f"main path did not launch B1 and B4 once per batch: {launches}")
    require(ids.shape == (MAIN_B, MAIN_K) and dists.shape == (MAIN_B, MAIN_K),
            "result shape")
    require(bool(np.isfinite(dists).all()), "non-finite distances")
    recall = recall_at_k(ids, gt, MAIN_K)
    # the nearest distance must agree with the exact one (sqrt at the edge)
    pts_d = torch.as_tensor(pts, device="cuda")
    q_d = torch.as_tensor(q, device="cuda")
    exact0 = torch.sqrt(torch.sum((pts_d[torch.as_tensor(gt[:, 0], device="cuda").long()] - q_d) ** 2, -1))
    d0_err = float(np.max(np.abs(dists[:, 0] - exact0.cpu().numpy())))
    require(recall >= 0.97, f"recall@10 {recall} < 0.97")
    med = float(np.median(batch_s))
    emit({
        "phase": "main", "n": MAIN_N, "d": MAIN_D, "queries": MAIN_B, "k": MAIN_K,
        "recall_at_10": recall, "qps": MAIN_B / med,
        "ms_per_batch_median": med * 1e3, "ms_per_batch": [s * 1e3 for s in batch_s],
        "top1_dist_max_abs_err": d0_err, "launches": launches,
        "launches_per_search_batch": {k: v / reps for k, v in launches.items()},
        "setup_seconds": setup_s,
        "search_type": stats["search_type"], "card": smi,
    })

    emit(profile_batch(engine, q))
    emit({"phase": "pipelined", "cell": "flat-1M-int8", "check": "event_wait_releases_gil",
          **event_wait_releases_gil(), "card": smi})
    write_metadata(base, "bench_1m", MAIN_N)
    pipelined_row(smi, engine, q, "flat-1M-int8", expect={"B1": "batches", "B4": "batches"})

    # kernel times at the main path's shapes (these launches are not
    # counted above: the counts were read before)
    flat = engine.flat
    qc, qs = fs.quantize_int8(q_d)
    nb, n_valid = 512, flat._fused_n_valid
    args = (qc, flat._fused_db, flat._fused_db_norms)
    kw = dict(n_buckets=nb, use_norms=True, q_scales=qs, n_valid=n_valid)
    vals, row = compare_b1(*args, **kw)
    err = row["max_abs_err"]
    ops = fs._scan_operands(*args, db_scales=None, **kw)
    b1_ms = cuda_ms(lambda: fs.scan_bucketed_topk(*args, **kw), 20)
    b1_device = kernel_device_ms(lambda: fs.scan_bucketed_topk(*args, **kw), 10)
    b1_plain = cuda_ms(lambda: fs.scan_bucketed_topk_ref(*ops), 3)
    kk = 40
    lk, lr = fs.topk_lanes(vals, kk), fs.topk_lanes_ref(vals, kk)
    # B4 returns lanes: its error is the largest difference between lanes
    b4_err = float((lk - lr).abs().max())
    require(bool(torch.equal(lk, lr)), f"B4 differs at the main-path shape by {b4_err} lanes")
    b4_times = b4_timed(vals, kk)
    b1_bound, b1_by = b1_bound_ms(MAIN_B, n_valid, MAIN_D, nb)
    b4_bound, b4_by = b4_bound_ms(MAIN_B, nb, kk)
    kernels = [
        {"name": "B1 flat_scan (per-row int8 scan + bucket fold)", "route": "cuda",
         "source": "diskrag_tpu_torch/csrc/flat_scan.cu",
         "replaces": "diskrag_tpu/ops/flat_scan_pallas.py:42",
         "launches": launches["B1"], "max_abs_err": err, "match": "bit-identical",
         "ms": b1_ms, "plain_ms": b1_plain, "bound_ms": b1_bound, "bound_by": b1_by,
         "library_ms": None, "device_ms": b1_device,
         "plan": str(fs.plan_rowscan(MAIN_B, nb, flat._fused_db.shape[0], flat._fused_db.shape[1],
                                     torch.cuda.get_device_properties(0).multi_processor_count))},
        {"name": "B4 topk_lanes (candidate cut)", "route": "cuda",
         "source": "diskrag_tpu_torch/csrc/topk_lanes.cu",
         "replaces": "diskrag_tpu/ops/flat_scan_pallas.py:1244",
         "launches": launches["B4"], "max_abs_err": b4_err, "match": "bit-identical",
         **b4_times, "bound_ms": b4_bound, "bound_by": b4_by,
         "plan": str(fs.plan_cut(nb, kk))},
    ]
    del engine, flat, pts_d, q_d, vals
    torch.cuda.empty_cache()
    unfused_batch(smi, pts, q, gt)
    return {"kernels": kernels}


def unfused_batch(smi: str, pts, q, gt) -> None:
    """`FlatIndex(use_fused=False)` at 1M: the path a caller chooses
    instead of the scans (bf16 products and exact top-k over the whole
    table in query blocks, then the f32 rerank), which launches no
    kernel. One batch after a first call (that builds `vectors_bf16`),
    counts set to 0 just before and read just after; recall gate 0.97."""
    import torch

    from diskrag_tpu_torch.benchmark import recall_at_k
    from diskrag_tpu_torch.ops.flat import FlatIndex, bf16_query_block

    idx = FlatIndex(pts, use_fused=False, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    idx.search(q, k=MAIN_K)
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    dists, ids = idx.search(q, k=MAIN_K)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = read_counts()
    require(not any(launches.values()), f"FlatIndex(use_fused=False) launched {launches}")
    require(ids.shape == (MAIN_B, MAIN_K) and bool(torch.isfinite(dists).all()),
            "FlatIndex(use_fused=False): result shape or non-finite distances")
    recall = recall_at_k(ids.cpu().numpy(), gt, MAIN_K)
    require(recall >= 0.97, f"FlatIndex(use_fused=False) recall@10 {recall} < 0.97")
    emit({"phase": "main", "path": "FlatIndex(use_fused=False)", "n": MAIN_N, "d": MAIN_D,
          "queries": MAIN_B, "k": MAIN_K, "query_block": bf16_query_block(MAIN_B, MAIN_N),
          "recall_at_10": recall, "ms_per_batch": ms, "launches": launches,
          "peak_device_bytes": torch.cuda.max_memory_allocated(), "card": smi})
    del idx, dists, ids
    torch.cuda.empty_cache()


def b1_bf16_row(q_d, db, norms, reps: int) -> dict:
    """B1's bf16 form at NB 512 on one batch, as the engine hands it: held
    against its plain version (compare_b1), then timed launch to launch, on
    the device, beside its plain version, its bound and the product alone
    in PyTorch (`torch.matmul` of the f32 query and row copies, TF32 off;
    and on the bf16 copies, f32 sums rounded to a bf16 result): no single
    call computes the bucketed fold, so `library_ms` is that product alone."""
    import torch

    from diskrag_tpu_torch.ops import flat_scan as fs

    qb = q_d.to(torch.bfloat16)
    kw = dict(n_buckets=512, use_norms=True)
    _, row = compare_b1(qb, db, norms, **kw)
    ops = fs._scan_operands(qb, db, norms, q_scales=None, db_scales=None, n_valid=None, **kw)
    call = lambda: fs.scan_bucketed_topk(qb, db, norms, **kw)  # noqa: E731
    b, d = q_d.shape
    n = db.shape[0]
    bound, by = b1_bf16_bound_ms(b, n, d, 512)
    qf, dbf = ops[0].float(), db[:, :d].float()
    out = {"b": b, "n": n, "d": d, "nb": 512, "max_abs_err": row["max_abs_err"],
           "match": row["match"], "id_mismatches": row["id_mismatches"],
           "ms": cuda_ms(call, reps), "device_ms": kernel_device_ms(call, 5),
           "plain_ms": cuda_ms(lambda: fs.scan_bucketed_topk_ref(*ops), 2),
           "bound_ms": bound, "bound_by": by,
           "library_ms": cuda_ms(lambda: torch.matmul(qf, dbf.T), 3),
           "library_call": "torch.matmul(q_f32, rows_f32.T): the product alone",
           "library_bf16_ms": cuda_ms(lambda: torch.matmul(ops[0], db.T), 3),
           "plan": str(fs.plan_rowscan(b, 512, n, db.shape[1] * 2,
                                       torch.cuda.get_device_properties(0).multi_processor_count))}
    del qf, dbf
    torch.cuda.empty_cache()
    return out


def phase_main_bf16(smi: str, base, sets: dict) -> dict:
    """The bf16 flat path (`flat_precision: bf16`) at 1M through
    `build_index_from_vectors` and `SearchEngine.search_batch`: one launch
    of B1 (its bf16 form) and of B4 a batch and none of the others, recall
    against the exact ground truth, a profile; then B1 bf16's row of the
    kernels line at the shapes it serves (1M) and at 200k."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.benchmark import recall_at_k

    pts, q, gt = sets[MAIN_N]
    t0 = time.perf_counter()
    engine, _ = serve(base, "bf16_1m", pts, "bf16")
    setup_s = time.perf_counter() - t0
    flat = engine.flat
    require(flat._fused_db.dtype == torch.bfloat16, "the index is not bf16")
    reps = 5
    dists, ids, all_stats, batch_s, launches = drive(engine, q, reps)
    others = {k: v for k, v in launches.items() if k not in ("B1", "B4")}
    require(launches["B1"] == reps and launches["B4"] == reps and not any(others.values()),
            f"flat-1M-bf16 did not launch B1 and B4 once per batch and nothing else: {launches}")
    require(ids.shape == (MAIN_B, MAIN_K) and bool(np.isfinite(dists).all())
            and bool((np.diff(dists, axis=1) >= 0).all()), "distances not finite and ascending")
    recall = recall_at_k(ids, gt, MAIN_K)
    require(recall >= 0.97, f"bf16 recall@10 {recall} < 0.97")
    med = float(np.median(batch_s))
    emit({"phase": "main-bf16", "n": MAIN_N, "d": MAIN_D, "queries": MAIN_B, "k": MAIN_K,
          "recall_at_10": recall, "jax_package_recorded": 0.9909, "qps": MAIN_B / med,
          "ms_per_batch_median": med * 1e3, "ms_per_batch": [x * 1e3 for x in batch_s],
          "launches": launches, "launches_per_search_batch": {k: v / reps for k, v in launches.items()},
          "setup_seconds": setup_s, "search_type": all_stats[-1]["search_type"], "card": smi})
    emit(profile_batch(engine, q, path="flat-1M-bf16"))
    row = b1_bf16_row(torch.as_tensor(q, device="cuda"), flat._fused_db, flat.norms_sq, 10)
    del engine, flat
    torch.cuda.empty_cache()
    pts_s, q_s, _ = sets[CMP_N]
    v = torch.as_tensor(pts_s, device="cuda")
    at_200k = b1_bf16_row(torch.as_tensor(q_s, device="cuda"), v.to(torch.bfloat16),
                          torch.sum(v * v, -1), 20)
    del v
    torch.cuda.empty_cache()
    return {"name": "B1 flat_scan bf16 (per-row bf16 scan + bucket fold)", "route": "cuda",
            "source": "diskrag_tpu_torch/csrc/flat_scan.cu",
            "replaces": "diskrag_tpu/ops/flat_scan_pallas.py:42 (int8=False)",
            "launches": launches["B1"], **row, "at_200k": at_200k, "card": smi}


# recall@10 per rerank width that the JAX package records for its packed
# path on these two datasets (docs/PERFORMANCE.md): integer arithmetic, so
# the port should land on or near them whatever the card
REFERENCE_RECALL = {
    200_000: {17: 0.9537, 18: 0.9621, 20: 0.974},
    1_000_000: {18: 0.9449, 22: 0.9677, 26: 0.9782},
}


def packed_kernel_row(kind: str, flat, q_d, plan, *, cut_kk, reps: int) -> dict:
    """One packed fold at the shapes the main path hands it: held against
    its plain version, then timed (kernel launch to launch, its kernels on
    the device by name, plain version) and bounded. `max_abs_err` is
    measured on the scores of the fold's state output (a fused cut returns
    ids only, so the same fold is also run without the cut);
    `id_mismatches` on the ids of the form the main path uses."""
    import torch

    from diskrag_tpu_torch.ops import flat_scan as fs

    qc, qs = fs.quantize_int8_global(q_d)
    args = (qc, qs, flat._fused_db, flat._fused_nf, flat._fused_db_scale_global)
    kw = dict(n_buckets=512, query_block=plan.query_block, db_tile=plan.db_tile,
              n_valid=flat._fused_n_valid, cut_kk=cut_kk)
    _, measured = compare_packed(kind, *args, **kw)
    if cut_kk is not None:
        _, state = compare_packed(kind, *args, **{**kw, "cut_kk": None})
        measured["max_abs_err"] = state["max_abs_err"]
        measured["id_mismatches"] += state["id_mismatches"]
    if kind == "B2":
        ops = fs._packed_fold_operands(*args, **kw)
        call = lambda: fs.scan_bucketed_topk_packed(*args, **kw)  # noqa: E731
        plain = cuda_ms(lambda: fs.scan_bucketed_topk_packed_ref(*ops), 2)
    else:
        pipe = kind == "B6"
        ops = fs._hier_fold_operands(*args, pipelined=pipe, **kw)
        call = lambda: fs.scan_bucketed_topk_hier(*args, pipelined=pipe, **kw)  # noqa: E731
        plain = cuda_ms(lambda: fs.scan_bucketed_topk_hier_ref(*ops), 2)
    nb, n_valid = ops[4], ops[6]
    bound, by = packed_bound_ms(q_d.shape[0], n_valid, q_d.shape[1],
                                cut_kk if cut_kk else 2 * nb)
    # device time by kernel name: the partial kernel (B2 / B3: after the
    # pass that turns nf into each row's nc), then the merge (with the fused
    # cut where there is one)
    by_kernel = device_ms_by_kernel(call, 10)
    partial = "pingpong_wgmma_partial" if kind == "B6" else "packed_wgmma_partial"
    merge = "packed_scan_merge" if kind == "B2" else "hier_scan_merge"
    planner = fs.plan_pipelined_scan if kind == "B6" else fs.plan_packed_scan
    return {"nb": nb, "n_scan": ops[5], "n_valid": n_valid, "cut_kk": cut_kk,
            **measured, "match": "bit-identical", "ms": cuda_ms(call, reps),
            "device_ms": sum(by_kernel.values()) or None,
            "device_ms_nc_pass": named(by_kernel, "packed_nc_rows"),
            "device_ms_partial": named(by_kernel, partial),
            "device_ms_merge_cut": named(by_kernel, merge),
            "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": None,
            "plan": str(planner(q_d.shape[0], nb, ops[5] // nb, qc.shape[1],
                                torch.cuda.get_device_properties(0).multi_processor_count))}


def phase_main_packed(smi: str, base, sets: dict) -> list[dict]:
    """The packed main path (`flat_precision: int8_packed`) at both bench
    sizes through `build_index_from_vectors` and `SearchEngine.search_batch`;
    B2's and B3's times at the shapes it hands them; B6 through its wrapper
    at the 1M shape; one `sweep_flat` run at 200k; a profile at 1M."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.benchmark import recall_at_k, sweep_flat
    from diskrag_tpu_torch.ops import flat_scan as fs

    reps = 5
    rows = {}
    for n_pts, (fold, kernel, want_nb) in ((CMP_N, ("packed", "B2", 1024)),
                                           (MAIN_N, ("hier", "B3", 512))):
        pts, q, gt = sets[n_pts]
        t0 = time.perf_counter()
        engine, _ = serve(base, f"packed_{n_pts}", pts, "int8_packed")
        setup_s = time.perf_counter() - t0
        flat = engine.flat
        require(flat._fused_db_scale_global is not None, "the index is not packed")
        plan = fs.plan_packed_search(flat._fused_db.shape[0], flat._fused_n_valid, MAIN_D,
                                     MAIN_B, 512, 40)
        require((plan.fold, plan.nb, plan.cut_kk) == (fold, want_nb, 40),
                f"n={n_pts}: routed to {plan}, expected {fold} at NB={want_nb}")
        dists, ids, all_stats, batch_s, launches = drive(engine, q, reps)
        stats = all_stats[-1]
        others = {k: v for k, v in launches.items() if k != kernel}
        require(launches[kernel] == reps and not any(others.values()),
                f"n={n_pts}: expected {reps} launches of {kernel} and no other: {launches}")
        require(ids.shape == (MAIN_B, MAIN_K) and bool(np.isfinite(dists).all())
                and bool((np.diff(dists, axis=1) >= 0).all()),
                f"n={n_pts}: distances not finite and ascending")
        recall = recall_at_k(ids, gt, MAIN_K)
        require(recall >= 0.96, f"n={n_pts}: packed recall@10 {recall} < 0.96")
        by_width = {}
        for rw, ref in REFERENCE_RECALL[n_pts].items():
            flat.rerank_width = rw
            _, ids_w, _ = engine.search_batch(q, k=MAIN_K)
            by_width[rw] = {"recall_at_10": recall_at_k(ids_w, gt, MAIN_K),
                            "jax_package_recorded": ref}
        flat.rerank_width = None
        med = float(np.median(batch_s))
        emit({
            "phase": "main-packed", "n": n_pts, "d": MAIN_D, "queries": MAIN_B, "k": MAIN_K,
            "fold": fold, "kernel": kernel, "nb": plan.nb, "n_scan": plan.n_scan, "cut_kk": 40,
            "recall_at_10": recall, "recall_by_rerank_width": by_width,
            "qps": MAIN_B / med, "ms_per_batch_median": med * 1e3,
            "ms_per_batch": [s * 1e3 for s in batch_s], "launches": launches,
            "launches_per_search_batch": {k: v / reps for k, v in launches.items()},
            "setup_seconds": setup_s, "search_type": stats["search_type"], "card": smi,
        })
        write_metadata(base, f"packed_{n_pts}", n_pts)
        pipelined_row(smi, engine, q, f"flat-{'1M' if n_pts == MAIN_N else '200k'}-packed",
                      expect={kernel: "batches"})
        q_d = torch.as_tensor(q, device="cuda")
        rows[kernel] = {"launches": launches[kernel],
                        **packed_kernel_row(kernel, flat, q_d, plan, cut_kk=40, reps=20)}
        if n_pts == CMP_N:
            headline = headline_point(smi, engine, q, gt)
        if n_pts == MAIN_N:
            emit(profile_batch(engine, q, path="flat-1M-packed"))
            # B6: its entry point is the wrapper with pipelined=True (no engine
            # option selects it, as in the JAX package). Driven at the 1M
            # shape with the counts set to 0 just before and read just after
            qc, qs = fs.quantize_int8_global(q_d)
            args = (qc, qs, flat._fused_db, flat._fused_nf, flat._fused_db_scale_global)
            kw = dict(n_buckets=512, n_valid=flat._fused_n_valid)
            fs.reset_launch_counts()
            for _ in range(3):
                b6 = fs.scan_bucketed_topk_hier(*args, pipelined=True, **kw)
            torch.cuda.synchronize()
            b6_launches = fs.scan_bucketed_topk_hier.launches_pipelined
            require(b6_launches == 3 and fs.scan_bucketed_topk_hier.launches == 0,
                    "the pipelined wrapper did not launch B6")
            b3 = fs.scan_bucketed_topk_hier(*args, db_tile=1024, **kw)
            require(bool(torch.equal(b6[0], b3[0]) and torch.equal(b6[1], b3[1])),
                    "B6 differs from B3 at the 1M shape")
            rows["B6"] = {"launches": b6_launches,
                          **packed_kernel_row("B6", flat, q_d, plan, cut_kk=None, reps=20)}
            rows["B3"]["ms_without_cut"] = cuda_ms(
                lambda: fs.scan_bucketed_topk_hier(*args, **kw), 20)
        del engine, flat, q_d
        torch.cuda.empty_cache()

    pts, q, gt = sets[CMP_N]
    t0 = time.perf_counter()
    points = sweep_flat(pts, q, gt, k=MAIN_K, repeats=3, min_seconds=0.3, device="cuda")
    emit({"phase": "sweep_flat", "n": CMP_N, "d": MAIN_D, "queries": MAIN_B, "k": MAIN_K,
          "seconds": time.perf_counter() - t0, "card": smi,
          "points": [{"mode": p.mode, "rerank_width": p.search_width, "recall": p.recall,
                      "qps": p.qps, "ms_per_batch": p.mean_latency_ms * MAIN_B}
                     for p in points]})
    torch.cuda.empty_cache()

    meta = {
        "B2": ("B2 packed_scan (packed-int32 fold + fused cut)",
               "diskrag_tpu_torch/csrc/packed_scan.cu", "diskrag_tpu/ops/flat_scan_pallas.py:325"),
        "B3": ("B3 hier_scan (hierarchical packed fold + fused cut)",
               "diskrag_tpu_torch/csrc/hier_scan.cu", "diskrag_tpu/ops/flat_scan_pallas.py:387"),
        "B6": ("B6 hier_scan pipelined (ping-pong wgmma: one consumer folds while the other's "
               "product runs)",
               "diskrag_tpu_torch/csrc/pingpong_wgmma.cuh", "diskrag_tpu/ops/flat_scan_pallas.py:468"),
    }
    rows["B3"]["bench_headline_shape"] = headline
    return [{"name": meta[k][0], "route": "cuda", "source": meta[k][1],
             "replaces": meta[k][2], **rows[k]} for k in ("B2", "B3", "B6")]


def headline_point(smi: str, engine, q, gt) -> dict:
    """The bench's headline point through the 200k packed engine: one
    `search_batch` of `BIG_B` queries (the batch tiled) at rerank width
    `BIG_RW`, counts set to 0 just before and read just after (one B3
    launch, nothing else; recall over the leading rows, gate 0.96); then
    B3 at that batch's shapes against its plain version, timed and
    bounded."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.benchmark import recall_at_k
    from diskrag_tpu_torch.ops import flat_scan as fs

    flat = engine.flat
    qb = np.asarray(q)[np.arange(BIG_B) % len(q)]
    plan = fs.plan_packed_search(flat._fused_db.shape[0], flat._fused_n_valid, MAIN_D, BIG_B,
                                 512, BIG_RW)
    require((plan.fold, plan.nb, plan.cut_kk) == ("hier", 512, BIG_RW),
            f"the headline batch routed to {plan}")
    flat.rerank_width = BIG_RW
    try:
        engine.search_batch(qb, k=MAIN_K)  # this batch shape's first call
        dists, ids, all_stats, batch_s, launches = drive(engine, qb, 3)
    finally:
        flat.rerank_width = None
    others = {k: v for k, v in launches.items() if k != "B3"}
    require(launches["B3"] == 3 and not any(others.values()),
            f"the headline batch did not launch B3 once a batch and nothing else: {launches}")
    require(ids.shape == (BIG_B, MAIN_K) and bool(np.isfinite(dists).all()),
            "headline batch: result shape or non-finite distances")
    recall = recall_at_k(ids[: len(q)], gt, MAIN_K)
    require(recall >= 0.96, f"headline recall@10 {recall} < 0.96")
    med = float(np.median(batch_s))
    emit({"phase": "main-packed", "cell": "flat-200k-packed-b2048", "n": CMP_N, "queries": BIG_B,
          "rerank_width": BIG_RW, "fold": plan.fold, "nb": plan.nb, "n_scan": plan.n_scan,
          "recall_at_10": recall, "jax_package_recorded": 0.9699, "qps": BIG_B / med,
          "ms_per_batch_median": med * 1e3, "ms_per_batch": [s * 1e3 for s in batch_s],
          "launches": launches, "card": smi})
    q_d = torch.as_tensor(qb, device="cuda")
    return {"b": BIG_B, "n": CMP_N, "launches": launches["B3"], "recall_at_10": recall,
            **packed_kernel_row("B3", flat, q_d, plan, cut_kk=BIG_RW, reps=20)}

# recall@10 that the JAX package records on this dataset (200,000 x 128,
# seed 42) for a graph of degree 48, alpha 1.2 (benchmarks/last_bench_tpu.json):
# recall is a property of the algorithm, so a graph built by the port,
# which draws other random numbers, is held to these within a margin
REFERENCE_GRAPH_RECALL = {
    ("exact", 16, 8): 0.9948, ("exact", 16, 12): 0.9904,
    ("rpq32+rerank", 32, 4): 0.9393, ("rpq32+rerank", 64, 4): 0.9896,
}


# recall@10 the default-parameter index (R = 24, residual PQ m = 16) must
# reach at l_search = 64 on the 200k set. 16 subvectors of 8 dimensions
# order neighbours too coarsely for 0.95 at that width (measured 0.8489 on
# an H100; the m = 32 sweep above reaches 0.991 at the same L with E = 4):
# the gate sits 0.01 under what the defaults reach, and the engine's own
# default width (the build's recommended L) is printed beside it
VAMANA_RECALL_GATE = 0.838


@contextlib.contextmanager
def _no_gather_adc():
    """While active, the gather formulation of the ADC lookup counts its
    calls: the PQ-guided traversal must not reach it on the card."""
    from diskrag_tpu_torch.pq import product_quantizer as tpq
    from diskrag_tpu_torch.pq import residual as tres

    calls = {"n": 0}
    real = tpq.adc_lookup_gathered

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    tpq.adc_lookup_gathered = tres.adc_lookup_gathered = counted
    try:
        yield calls
    finally:
        tpq.adc_lookup_gathered = tres.adc_lookup_gathered = real


@contextlib.contextmanager
def _calls(module, attr: str):
    """While active, counts the calls of `module.<attr>` made through the
    module's name (a caller that looks the function up at each call)."""
    calls = {"n": 0}
    real = getattr(module, attr)

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    setattr(module, attr, counted)
    try:
        yield calls
    finally:
        setattr(module, attr, real)


def sweep_searches(points, n_queries: int, pipeline: int = 4) -> int:
    """The searches a `sweep_exact` run made: its batch in `pipeline`
    chunks, one search each, in every pass (warm-up included)."""
    step = -(-n_queries // pipeline)
    return sum(p.passes for p in points) * -(-n_queries // step)


# G1 against the plain rounds: the exact cell's shape (1M x 128, R 48, L 32,
# E 1, the index's entry points) at B = 1 and 512, and the 200k sweep's
# (L 16, E 8, 1000 queries); (B, L, E)
G1_CELL_SHAPES = ((1, 32, 1), (512, 32, 1))
G1_SWEEP_SHAPES = ((1000, 16, 8),)
G1_ID_SHARE = 0.995  # rows with identical top-10 ids, and with equal visited sets, on floats
G1_DIST_TOL = 1e-5  # of qn + vn, the scale the norm expansion rounds at
G1_STAGES = ("select_adjacency", "score", "cut_dedupe_merge")  # a round, by the stage clock


def g1_bound_ms(vectors, adjacency, queries, plain, seed_width: int) -> tuple[float, str]:
    """Least time for G1's work from a seeded list, read off the plain
    rounds' visited log: bytes, each distinct expanded node's adjacency row
    and each distinct vector those rows name read once across the batch
    (a vector several queries score is read once), the queries and the
    seeded list read, the final state written; operations, 3 D (a
    difference, a product, a sum) for each distinct neighbour a query
    scores."""
    import torch

    b, d = queries.shape
    r = adjacency.shape[1]
    vis = plain.visited_ids
    expanded = torch.unique(vis[vis >= 0])
    nbrs = adjacency[vis.clamp_min(0).long()]
    nbrs = torch.where((vis >= 0)[..., None], nbrs, -1).reshape(b, -1)
    srt = torch.sort(nbrs, dim=1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    scored = int((first & (srt >= 0)).sum())
    distinct = torch.unique(srt[srt >= 0]).numel()
    v = vis.shape[1]
    nbytes = (expanded.numel() * r * 4 + distinct * d * 4 + b * d * 4 + b * seed_width * 9
              + b * (seed_width * 8 + v * 8 + 4))
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 3.0 * d * scored / PEAK_F32_OPS
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")


def g1_stage_split(vecs, adjacency, qs, seeded, *, expand_width: int, max_steps: int) -> dict:
    """G1's round in stages, from its stage-clock build (`-DG1_STAGE_CLOCK`,
    a library of its own; the default build carries no timer): thread 0's
    %globaltimer at a round's start, after barrier 1, after barrier 2 and
    after the merge, for every query. Returns the mean microseconds a round
    of select and adjacency (start to barrier 1), the scoring (barrier 1 to
    2), the cut, dedupe and merge (barrier 2 to the end) and the whole
    round, over every executed round of every query, from the second of two
    launches (the first warms the caches)."""
    import ctypes

    import torch

    from diskrag_tpu_torch.kernels import _build
    from diskrag_tpu_torch.ops import traverse

    defines = ("G1_STAGE_CLOCK",)
    lib = _build.load("beam_traverse", defines)
    lib.beam_traverse_stage_buffer.argtypes = [ctypes.c_void_p]
    b, l = seeded[0].shape
    stamps = torch.zeros((b, max_steps, 4), dtype=torch.int64, device=vecs.device)
    lib.beam_traverse_stage_buffer(stamps.data_ptr())
    seeded = tuple(t.contiguous() for t in seeded)
    for _ in range(2):
        stamps.zero_()
        out = traverse._traverse_outputs(b, l, max_steps * expand_width, vecs.device, zeroed=True)
        traverse._launch_traverse(vecs, adjacency, qs.contiguous(), seeded, out,
                                  expand_width=expand_width, max_steps=max_steps, dev=vecs.device,
                                  stream=torch.cuda.current_stream(vecs.device).cuda_stream,
                                  defines=defines)
        torch.cuda.synchronize()
    t = stamps.double()
    done = t[..., 3] > 0
    parts = [t[..., i + 1] - t[..., i] for i in range(3)] + [t[..., 3] - t[..., 0]]
    split = {name: float(x[done].mean()) / 1e3 for name, x in zip(G1_STAGES + ("round",), parts)}
    return {"us_a_round": split, "rounds_timed": int(done.sum())}


def g1_stage_clock_sass() -> dict:
    """%globaltimer reads (S2UR / CS2R of SR_GLOBALTIMER*) in G1's kernels:
    none in the default library, some in the stage-clock build."""
    from diskrag_tpu_torch.kernels import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    require(tool.exists(), f"no cuobjdump beside nvcc ({tool}): G1's stage clock unchecked")
    found = {}
    for name, defines in (("default", ()), ("stage_clock", ("G1_STAGE_CLOCK",))):
        _build.load("beam_traverse", defines)
        lib = _build._lib_path(_build.CSRC / "beam_traverse.cu", defines)
        sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=120).stdout
        found[name] = sass.count("GLOBALTIMER")
    require(found["default"] == 0 < found["stage_clock"],
            f"G1's stage clock in the wrong build: {found}")
    return found


def _sorted_log(res):
    import torch

    ids, order = torch.sort(res.visited_ids, dim=1)
    return ids, torch.gather(res.visited_dists, 1, order)


def g1_compare(kern, plain, vectors, queries, gt, *, exact: bool, what: str) -> dict:
    """G1's search against the plain rounds' from the same seeding. On
    integer data (`exact`: every product and sum exact in f32) the whole
    beam, the visited log, n_expanded and n_steps are bit-identical. On
    float data the two sum in other orders, so a near-tie can break the
    other way and change which node a round expands: the top-10 ids
    identical and the visited logs equal as sets each on `G1_ID_SHARE` of
    the rows (all rows below 200), on the rows where both hold n_expanded
    equal and every distance of the top 10 and of the log within
    `G1_DIST_TOL` of qn + vn, recall@10 within 1e-3 and n_steps equal. The
    figures are emitted before they are gated."""
    import torch

    from diskrag_tpu_torch.benchmark import recall_at_k

    fields = ("ids", "dists", "visited_ids", "visited_dists", "n_expanded", "n_steps")
    if exact:
        diff = [f for f in fields if not torch.equal(getattr(kern, f), getattr(plain, f))]
        require(not diff, f"G1 differs from the plain rounds on integer data at {what}: {diff}")
        require(int(kern.n_steps) > 0, f"G1 ran no round at {what}")
        return {"match": "bit-identical", "n_steps": int(kern.n_steps)}
    same = (kern.ids[:, :10] == plain.ids[:, :10]).all(1)
    kv, kvd = _sorted_log(kern)
    pv, pvd = _sorted_log(plain)
    logs = (kv == pv).all(1)
    both = same & logs
    qn = (queries * queries).sum(1, keepdim=True)[both]

    def within(a, b, ids):
        fin = torch.isfinite(b)
        v = vectors[ids.clamp_min(0).long()]
        err = ((a - b).abs() / (qn + (v * v).sum(-1)))[fin]
        return torch.equal(fin, torch.isfinite(a)), float(err.max()) if err.numel() else 0.0

    beam_ok, beam_err = within(kern.dists[both, :10], plain.dists[both, :10],
                               plain.ids[both, :10])
    log_ok, log_err = within(kvd[both], pvd[both], pv[both])
    got = recall_at_k(kern.ids[:, :10].cpu().numpy(), gt, 10)
    want = recall_at_k(plain.ids[:, :10].cpu().numpy(), gt, 10)
    row = {"match": f"statistical: top-10 ids and visited sets, distances within {G1_DIST_TOL} "
                    "of qn + vn",
           "rows": len(same), "top10_identical_share": float(same.float().mean()),
           "visited_set_identical_share": float(logs.float().mean()),
           "beam_identical_share": float((kern.ids == plain.ids).all(1).float().mean()),
           "visited_order_identical_share": float(
               (kern.visited_ids == plain.visited_ids).all(1).float().mean()),
           "n_expanded_equal_on_identical_rows": bool(torch.equal(kern.n_expanded[both],
                                                                  plain.n_expanded[both])),
           "max_dist_err_over_qn_vn": max(beam_err, log_err), "recall_at_10": got,
           "plain_recall_at_10": want, "n_steps": int(kern.n_steps),
           "plain_n_steps": int(plain.n_steps)}
    emit({"phase": "g1", "compare": what, **row})
    need = 1.0 if len(same) < 1 / (1 - G1_ID_SHARE) else G1_ID_SHARE
    require(row["top10_identical_share"] >= need and row["visited_set_identical_share"] >= need,
            f"G1 at {what}: top-10 ids identical on {row['top10_identical_share']} of rows, "
            f"visited sets on {row['visited_set_identical_share']}")
    require(row["n_expanded_equal_on_identical_rows"],
            f"G1 at {what}: n_expanded differs on a row of identical top-10 ids and visited set")
    require(beam_ok and log_ok and row["max_dist_err_over_qn_vn"] <= G1_DIST_TOL,
            f"G1 at {what}: a distance off by {row['max_dist_err_over_qn_vn']} of qn + vn")
    require(abs(got - want) <= 1e-3, f"G1 at {what}: recall@10 {got} against the plain {want}")
    require(row["n_steps"] == row["plain_n_steps"] > 0,
            f"G1 at {what}: n_steps {row['n_steps']} against the plain {row['plain_n_steps']}")
    return row


def g1_rows(smi: str, index, q, gt, shapes, cell: str) -> dict:
    """G1 held against the plain rounds (`_plain_rounds`) from the same
    seeded state (`_seed_candidates`) over `index` at each (B, L, E) of
    `shapes`: on the SIFT-like float queries and on the same graph with
    vectors and queries scaled by 4 and rounded to integers (bit for bit;
    `g1_compare`), then timed: G1 from the seeded state on the device
    (`device_ms`) and launch to launch (`cuda_ms`), the plain rounds from
    the same state (CUDA events around whole calls: the host's dispatch
    and its waits a round), the whole `beam_search` (seeding and G1) and
    the bound (`g1_bound_ms`); beside them whether the launch takes the warp
    path (`traverse_plan`) and the round's stages from the stage-clock build
    (`g1_stage_split`; the default build is checked to carry no timer).
    `launches`: the counts of one `beam_search` at the shape, set to 0 just
    before: G1 once and nothing else."""
    import torch

    from diskrag_tpu_torch.graph import search as tsearch
    from diskrag_tpu_torch.ops import traverse
    from diskrag_tpu_torch.ops.distance import pairwise_distance

    qd = torch.as_tensor(q, dtype=torch.float32, device="cuda")
    ints = (torch.round(index.vectors * 4), torch.round(qd * 4))
    rows = {}
    sass = g1_stage_clock_sass()
    for b, width, e in shapes:
        what = f"{cell} B={b} L={width} E={e}"
        steps = tsearch._default_steps(width, e, MAIN_K, None)
        row = {"b": b, "n": index.vectors.shape[0], "d": index.vectors.shape[1],
               "r": index.adjacency.shape[1], "L": width, "E": e, "max_steps": steps,
               "entry_points": int(index.entry_points.shape[0])}
        for label, (vecs, qs) in (("floats", (index.vectors, qd[:b])),
                                  ("ints", (ints[0], ints[1][:b]))):
            def expand(ids, vecs=vecs, qs=qs):
                return tsearch._gathered_distance(qs, vecs[ids], "l2")

            def seed_expand(seeds, vecs=vecs, qs=qs):
                return pairwise_distance(qs, vecs[seeds], "l2")

            kw = dict(search_width=width, k=width, expand_width=e,
                      entry_points=index.entry_points)
            reset_counts()
            kern = tsearch.beam_search(vecs, index.adjacency, index.medoid, qs, **kw)
            torch.cuda.synchronize()
            launches = read_counts()
            require(launches == {**{k: 0 for k in launches}, **searches_on_the_card(1)},
                    f"beam_search at {what} launched {launches}, expected G2 and G1 once")
            seeded = tsearch._seed_candidates(index.adjacency, index.medoid, seed_expand, b,
                                              search_width=width, entry_points=index.entry_points)
            plain = tsearch._plain_rounds(index.adjacency, expand, *seeded, k=width,
                                          max_steps=steps, expand_width=e)
            torch.cuda.synchronize()
            row[label] = g1_compare(kern, plain, vecs, qs, gt[:b], exact=label == "ints",
                                    what=f"{what} {label}")
            if label == "ints":
                continue
            kern_call = lambda: traverse.beam_traverse(  # noqa: E731
                vecs, index.adjacency, qs, *seeded, expand_width=e, max_steps=steps)
            ms, timed_by = device_ms(kern_call, 20)
            bound, by = g1_bound_ms(vecs, index.adjacency, qs, plain, width)
            row.update(
                launches=launches, device_ms=ms, timed_by=timed_by,
                ms=cuda_ms(kern_call, 20),
                plain_ms=cuda_ms(lambda: tsearch._plain_rounds(
                    index.adjacency, expand, *seeded, k=width, max_steps=steps,
                    expand_width=e), 3),
                search_ms=cuda_ms(lambda: tsearch.beam_search(
                    vecs, index.adjacency, index.medoid, qs, **kw), 20),
                bound_ms=bound, bound_by=by, rounds=int(kern.n_steps),
                device_us_a_round=ms * 1e3 / max(int(kern.n_steps), 1),
                warp_path=traverse.traverse_plan(e, index.adjacency.shape[1], width),
                stages=g1_stage_split(vecs, index.adjacency, qs, seeded, expand_width=e,
                                      max_steps=steps), stage_clock_sass=sass)
        emit({"phase": "g1", "cell": cell, **row, "card": smi})
        rows[f"b{b}_l{width}_e{e}"] = row
    del ints
    torch.cuda.empty_cache()
    return rows


def g1_kernel_row(rows: dict) -> dict:
    """G1's entry in the `kernels` line: the exact cell's B = 1 row at the
    top, every other shape `g1_rows` held under its own key."""
    head, *rest = rows
    return {"name": "G1 beam_traverse (the exact traversal's rounds: a block a query, every "
                    "round in one launch)",
            "route": "cuda", "source": "diskrag_tpu_torch/csrc/beam_traverse.cu",
            "replaces": "diskrag_tpu/graph/search.py:305 (lax.while_loop; no pallas_call)",
            "shape": head, **rows[head], **{f"{k}_shape": rows[k] for k in rest}}


# G2 against the plain seeding at the exact cells' shape (1M x 128, the
# index's entry points and the medoid, L 32); (B, L)
G2_CELL_SHAPES = ((1, 32), (512, 32))


def g2_bound_ms(b: int, s: int, d: int, l: int) -> tuple[float, str, float]:
    """Least time for G2's work: bytes, each seed row and id read once, the
    queries read, the seeded list written (ids, distances, flags); operations,
    2 D for each (query, seed) pair; the larger, its name, and the byte
    bound alone."""
    nbytes = s * d * 4 + (s - 1) * 4 + b * d * 4 + b * l * 9
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 2.0 * d * b * s / PEAK_F32_OPS
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes",
            t_bytes * 1e3)


def g2_rows(smi: str, index, q, shapes, cell: str) -> dict:
    """G2 (`ops/traverse.py::beam_seed`) held against the plain seeding
    (`_seed_candidates`, its seed scores by `pairwise_distance`) over
    `index` at each (B, L) of `shapes`: bit for bit on the graph's vectors
    and the queries scaled by 4 and rounded to integers, on the float data
    the share of rows with identical seeded ids; then timed, both on the
    device (`device_ms`) and launch to launch (`cuda_ms`), beside the bound
    (`g2_bound_ms`). `launches`: one `beam_search` at the shape launches G2
    and G1 once each and nothing else."""
    import torch

    from diskrag_tpu_torch.graph import search as tsearch
    from diskrag_tpu_torch.ops import traverse
    from diskrag_tpu_torch.ops.distance import pairwise_distance

    qd = torch.as_tensor(q, dtype=torch.float32, device="cuda")
    ints = (torch.round(index.vectors * 4), torch.round(qd * 4))
    ep, med = index.entry_points, index.medoid
    s = 1 + ep.shape[0]
    rows = {}
    for b, width in shapes:
        what = f"{cell} B={b} L={width}"
        qt, tiles, ns = traverse.seed_plan(b, s, width, qd.shape[1],
                                           traverse._sm_count(qd.device.index))
        row = {"b": b, "n": index.vectors.shape[0], "d": index.vectors.shape[1], "L": width,
               "seeds": s, "queries_a_tile": qt, "tiles": tiles, "slices": ns}

        def plain(vecs, qs, width=width):
            def seed_expand(seeds):
                return pairwise_distance(qs, vecs[seeds], "l2")

            return tsearch._seed_candidates(index.adjacency, med, seed_expand, qs.shape[0],
                                            search_width=width, entry_points=ep)

        for label, (vecs, qs) in (("ints", (ints[0], ints[1][:b])),
                                  ("floats", (index.vectors, qd[:b]))):
            got = traverse.beam_seed(vecs, qs, med, ep, search_width=width)
            want = plain(vecs, qs)
            torch.cuda.synchronize()
            if label == "ints":
                diff = [name for name, g, w in zip(("ids", "dists", "expanded"), got, want)
                        if not torch.equal(g, w)]
                require(not diff, f"G2 differs from the plain seeding on integer data at {what}: "
                                  f"{diff}")
                row["ints"] = "bit-identical"
            else:
                row["floats_ids_identical_share"] = float((got[0] == want[0]).all(1)
                                                         .float().mean())
        qs = qd[:b]
        reset_counts()
        tsearch.beam_search(index.vectors, index.adjacency, med, qs, search_width=width, k=MAIN_K,
                            entry_points=ep)
        torch.cuda.synchronize()
        launches = read_counts()
        require(launches == {**{k: 0 for k in launches}, **searches_on_the_card(1)},
                f"beam_search at {what} launched {launches}, expected G2 and G1 once")
        call = lambda: traverse.beam_seed(index.vectors, qs, med, ep,  # noqa: E731
                                          search_width=width)
        ms, timed_by = device_ms(call, 50)
        plain_ms, plain_by = device_ms(lambda: plain(index.vectors, qs), 10)
        bound, by, bytes_ms = g2_bound_ms(b, s, index.vectors.shape[1], width)
        row.update(launches=launches, device_ms=ms, timed_by=timed_by, ms=cuda_ms(call, 50),
                   plain_device_ms=plain_ms, plain_timed_by=plain_by,
                   plain_ms=cuda_ms(lambda: plain(index.vectors, qs), 10),
                   bound_ms=bound, bound_by=by, bytes_bound_ms=bytes_ms)
        emit({"phase": "g2", "cell": cell, **row, "card": smi})
        rows[f"b{b}_l{width}"] = row
    del ints
    torch.cuda.empty_cache()
    return rows


def g2_kernel_row(rows: dict) -> dict:
    """G2's entry in the `kernels` line: the exact cells' B = 1 row at the
    top, the other shapes under their own keys."""
    head, *rest = rows
    return {"name": "G2 beam_seed (the exact search's seeded list: query tiles x seed slices, "
                    "the last block of a tile merges)",
            "route": "cuda", "source": "diskrag_tpu_torch/csrc/beam_seed.cu",
            "replaces": "diskrag_tpu_torch/graph/search.py::_seed_candidates on G1's searches "
                        "(no pallas_call)",
            "shape": head, **rows[head], **{f"{k}_shape": rows[k] for k in rest}}


def phase_main_graph(smi: str, pts, q, gt) -> dict:
    """The graph path: build the degree-48 graph on the card (B1 and B4 in
    its kNN pass), train and encode a 32-subvector residual PQ, then sweep
    exact traversal (L = 16, E = 8 and 12; G1 once a search, and held
    against the plain rounds at L = 16 / E = 8, `g1_rows`) and PQ-guided
    traversal + rerank (L = 32 and 64, E = 4; B5 once per executed round).
    The recall limits
    and the JAX package's recorded recalls belong to the bench's core-stage
    size (200,000 points) and apply there only."""
    import torch

    from diskrag_tpu_torch.benchmark import sweep_exact, sweep_pq
    from diskrag_tpu_torch.graph.knn_build import build_vamana_knn
    from diskrag_tpu_torch.pq import ResidualPQ

    stages: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    index = build_vamana_knn(pts, degree_bound=48, alpha=1.2, seed=0, device="cuda",
                             stage_seconds=stages)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = read_counts()
    if len(pts) <= 2_000_000:
        require(build_launches["B1"] > 0 and build_launches["B4"] == build_launches["B1"],
                f"the graph build did not go through B1 and B4: {build_launches}")
    else:  # "auto" takes the ivf kNN backend: no flat scan
        require(build_launches["B1"] == 0 and build_launches["B4"] == 0,
                f"the ivf-backend graph build launched B1 / B4: {build_launches}")
    adj = index.adjacency
    n = adj.shape[0]
    require(adj.shape == (n, 48) and int(adj.max()) < n and int(adj.min()) >= -1,
            "adjacency out of range")
    require(not bool((adj == torch.arange(n, device=adj.device)[:, None]).any()), "self edges")
    emit({"phase": "main-graph", "step": "build", "n": n, "d": pts.shape[1], "degree_bound": 48,
          "alpha": 1.2, "build_seconds": build_s, "stage_seconds": stages,
          "launches": build_launches, "mean_degree": float(index.degrees().float().mean()),
          "entry_points": int(index.entry_points.shape[0]),
          "peak_device_gb": build_peak_bytes(stages) / 2**30, "card": smi})

    g1 = g1_rows(smi, index, q, gt, G1_SWEEP_SHAPES, f"{n // 1000}k R48 sweep")
    reset_counts()
    points = sweep_exact(index, q, gt, k=MAIN_K, widths=(16,), expand_widths=(8, 12),
                         min_seconds=0.5)
    exact_launches = read_counts()
    searches = sweep_searches(points, len(q))
    require(exact_launches == {**{k: 0 for k in exact_launches},
                               **searches_on_the_card(searches)},
            f"the exact sweep launched {exact_launches}, expected G2 and G1 once a search "
            f"({searches})")
    t0 = time.perf_counter()
    rpq = ResidualPQ(32, device="cuda").fit(pts, seed=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes, cells = rpq.encode(pts)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0

    # the counts set to 0 just before the PQ sweep and read just after: B5
    # must be launched once per round the sweep reports having executed
    # (rounds of a pass x passes, warm-up included), the gather formulation never
    reset_counts()
    with _no_gather_adc() as gather_calls:
        pq_points = sweep_pq(index, rpq, codes, q, gt, k=MAIN_K, widths=(32, 64),
                             expand_widths=(4,), coarse_ids=cells, min_seconds=0.5)
    b5_launches = read_counts()["B5"]
    rounds = sum(p.rounds * p.passes for p in pq_points)
    require(b5_launches == rounds > 0 and gather_calls["n"] == 0,
            f"B5 launches {b5_launches} != rounds executed {rounds} "
            f"(gather formulation calls: {gather_calls['n']})")
    points += pq_points
    at_core_size = len(pts) == CMP_N
    rows = []
    for p in points:
        ref = REFERENCE_GRAPH_RECALL[p.mode, p.search_width, p.expand_width]
        rows.append({"mode": p.mode, "L": p.search_width, "E": p.expand_width,
                     "recall_at_10": p.recall, "jax_package_recorded": ref if at_core_size else None,
                     "qps": p.qps, "ms_per_1000_queries": p.mean_latency_ms * len(q),
                     "rounds_per_pass": p.rounds, "passes": p.passes})
    got = {(r["mode"], r["L"], r["E"]): r["recall_at_10"] for r in rows}
    if at_core_size:
        require(got["exact", 16, 8] >= 0.985,
                f"exact recall@10 L=16/E=8 {got['exact', 16, 8]} < 0.985")
        require(got["rpq32+rerank", 64, 4] >= 0.975,
                f"rpq32 recall@10 L=64/E=4 {got['rpq32+rerank', 64, 4]} < 0.975")
    emit({"phase": "main-graph", "step": "sweeps", "queries": len(q), "k": MAIN_K,
          "rpq_fit_seconds": fit_s, "rpq_encode_seconds": encode_s, "points": rows,
          "b5_launches_pq_sweep": b5_launches, "rounds_executed_pq_sweep": rounds,
          "g1_launches_exact_sweep": exact_launches["G1"],
          "gather_formulation_calls": gather_calls["n"], "card": smi})
    # B5 at the sweep's real operands (L = 64, E = 4 on a chunk of 250)
    chunk = torch.as_tensor(q[:250], device="cuda")
    nbrs = index.adjacency[index.adjacency[:250, :4].clamp_min(0).long()].reshape(250, -1)
    row = b5_row(rpq.inner_tables(chunk).contiguous(), codes[nbrs.clamp_min(0).long()])
    del index, codes, cells, rpq
    torch.cuda.empty_cache()
    return {"sweep_shape": row, "launches_pq_sweep": b5_launches, "g1": g1,
            "g1_launches_exact_sweep": exact_launches["G1"]}


def phase_main_vamana(smi: str, base, pts, q, gt) -> dict:
    """The default configuration through the normal entry points:
    `build_index_from_vectors(index_type="auto")` (vamana from 100k points
    up: R = 24, residual PQ with m = 16 at 200k), `SearchEngine`,
    `search_batch` at l_search = 64 and once at the engine's default."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.benchmark import recall_at_k

    t0 = time.perf_counter()
    engine, meta = serve(base, "vamana_200k", pts, None)
    setup_s = time.perf_counter() - t0
    require(meta["index_type"] == "vamana" and meta["use_pq"] and meta["pq_kind"] == "residual",
            f"defaults did not build a vamana index with a residual PQ: {meta.get('index_type')}")
    reps = 5
    with _no_gather_adc() as gather_calls:
        dists, ids, all_stats, batch_s, launches = drive(engine, q, reps, l_search=64)
    stats = all_stats[-1]
    rounds = sum(s["rounds"] for s in all_stats)
    require(stats["search_type"] == "pq_accelerated", f"served as {stats['search_type']}")
    others = {k: v for k, v in launches.items() if k != "B5"}
    require(launches["B5"] == rounds > 0 and not any(others.values()) and gather_calls["n"] == 0,
            f"expected {rounds} launches of B5 (one per round) and no other: {launches}")
    require(ids.shape == (MAIN_B, MAIN_K) and bool(np.isfinite(dists).all())
            and bool((np.diff(dists, axis=1) >= 0).all()), "distances not finite and ascending")
    recall = recall_at_k(ids, gt, MAIN_K)
    require(recall >= VAMANA_RECALL_GATE, f"vamana recall@10 {recall} < {VAMANA_RECALL_GATE} at l_search=64")
    pts_d = torch.as_tensor(pts, device="cuda")
    q_d = torch.as_tensor(q, device="cuda")
    d0 = torch.sqrt(torch.sum((pts_d[torch.as_tensor(ids[:, 0], device="cuda").long()] - q_d) ** 2, -1))
    d0_err = float(np.max(np.abs(dists[:, 0] - d0.cpu().numpy())))
    require(d0_err <= 1e-2, f"returned distances off their ids' exact ones by {d0_err}")
    med = float(np.median(batch_s))
    # once at the engine's own default width (the build's recommended L)
    t = time.perf_counter()
    _, ids_def, stats_def = engine.search_batch(q, k=MAIN_K)
    default_s = time.perf_counter() - t
    emit({
        "phase": "main-vamana", "n": len(pts), "d": pts.shape[1], "queries": MAIN_B, "k": MAIN_K,
        "R": meta["R"], "L_build": meta["L"], "pq_kind": meta["pq_kind"],
        "n_subvectors": meta["n_subvectors"], "pq_n_coarse": meta["pq_n_coarse"],
        "build_seconds_graph": meta["build_seconds"], "setup_seconds": setup_s,
        "l_search": 64, "recall_at_10": recall, "recall_gate": VAMANA_RECALL_GATE,
        "qps": MAIN_B / med, "ms_per_batch_median": med * 1e3,
        "ms_per_batch": [s * 1e3 for s in batch_s], "rounds_per_batch": rounds / reps,
        "launches": launches, "launches_per_search_batch": {k: v / reps for k, v in launches.items()},
        "search_type": stats["search_type"], "top1_dist_max_abs_err": d0_err,
        "default_l_search": {"l_search": stats_def["L_search"], "rounds": stats_def["rounds"],
                             "recall_at_10": recall_at_k(ids_def, gt, MAIN_K),
                             "ms_per_batch": default_s * 1e3},
        "card": smi,
    })
    prof = with_launches_per_round(
        profile_batch(engine, q, path="vamana-200k-rpq16", l_search=64,
                      watch=("adc_lookup_kernel",)), rounds / reps)
    emit(prof)
    write_metadata(base, "vamana_200k", len(pts))
    pipelined_row(smi, engine, q, "vamana-200k-default", expect={"B5": "rounds"}, l_search=64,
                  passes=1, profile_batches=2)
    # B5 at the engine's real operands: one round's ids (the adjacency rows
    # of the first 1000 points, clamped as the traversal clamps them), the
    # engine's code table and residual operands: the by-id form the round
    # calls, then the gathered form on the same round's codes
    g = engine.guide
    gt_q = g.tables(q_d)
    tables = gt_q.main.contiguous()
    aux = {"point_cell": g.cells, "point_bias": g.bias, "cell_tables": gt_q.cells}
    nbrs = engine.index.adjacency[:MAIN_B].clamp(0, g.codes.shape[0] - 1).long()
    by_id = b5_ids_row(tables, g.codes, nbrs, aux)
    gathered = b5_row(tables, g.codes[nbrs])
    del engine, pts_d, q_d
    torch.cuda.empty_cache()
    return {"launches": launches["B5"], "rounds_per_batch": rounds / reps,
            "device_launches_per_round": prof.get("device_launches_per_round"),
            **by_id, "gathered_form_engine_shape": gathered, "auto_recall_at_64": recall}


def with_launches_per_round(prof: dict, rounds_per_batch: float) -> dict:
    """A profiled batch's device launches (kernels, copies and sets the
    profiler recorded) divided by the traversal rounds of a batch: null
    where the profiler recorded no device activity."""
    per_batch = prof.get("device_launches_per_batch")
    return {**prof, "rounds_per_batch": rounds_per_batch,
            "device_launches_per_round": (per_batch / rounds_per_batch
                                          if per_batch and rounds_per_batch else None)}


def m1_bound_ms(bpad: int, npad: int, d: int, nb_out: int, b: int, n: int) -> tuple[float, str]:
    """Least time for M1's work: the full product of the padded operands
    (2 * Bpad * Npad * D operations: the probe's point is that every
    product runs) at the int8 tensor-core peak, or each input byte read
    once (row codes, query codes) and each output written once
    ([Bpad, nb_out] + [Bpad] int32) at HBM bandwidth — the larger."""
    t_ops = 2.0 * bpad * npad * d / PEAK_INT8_OPS
    t_bytes = (n * d + b * d + bpad * nb_out * 4 + bpad * 4) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def named(by_kernel: dict, part: str) -> float | None:
    """Device ms of the kernels whose name holds `part`: one must be among
    those the profiler recorded. None where `profiled` kept no window (its
    reason is on a "profiler" line and in the by-kernel dict)."""
    if not by_kernel:
        return None
    ms = sum(v for k, v in by_kernel.items() if part in k)
    require(ms > 0, f"the profiler recorded no kernel named *{part}*: {sorted(by_kernel)}")
    return ms


M1_NB_OUT = 512
M1_LIB_CHUNK = 65536  # rows per torch._int_mm call: a [1024, 65536] int32 result is 256 MB


def packed_codes(pts, q):
    """The packed scans' integer operands on the card, as the micro script
    and the main path build them: (row codes aligned, table scale, query
    codes, query scale, f32 rows' squared norms)."""
    import torch

    from diskrag_tpu_torch.ops import flat_scan as fs

    v = torch.as_tensor(pts, device="cuda")
    gcodes, gscale = fs.quantize_int8_global(v)
    gq, gqs = fs.quantize_int8_global(torch.as_tensor(q, device="cuda"))
    return fs.align_code_rows(gcodes), gscale, gq, gqs, torch.sum(v * v, dim=-1)


def m1_case(gq, gcodes, tile: int, reps: int) -> dict:
    """M1's wrapper on card tensors against its plain version (both
    outputs bit-identical), then timed beside the plain version, its bound
    and the library path: `torch._int_mm` on the same zero-padded operands
    in chunks of rows (timed alone as `library_ms`), and with the
    slice-and-add that turns its [Bpad, rows] results into M1's output
    (`library_with_slice_add_ms`)."""
    import torch

    from diskrag_tpu_torch.ops import mm_probe as mp

    b, d = gq.shape
    n = gcodes.shape[0]
    kw = dict(tile=tile, nb_out=M1_NB_OUT)
    got = mp.mm_probe(gq, gcodes, **kw)
    want = mp.mm_probe_ref(gq, gcodes, **kw)
    torch.cuda.synchronize()
    mism = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
    err = float((got[0].double() - want[0].double()).abs().max())
    require(mism == 0, f"M1 differs from its plain version at n={n} tile={tile}: {mism} entries")
    bpad = mp.padded_queries(b)
    npad = -(-n // tile) * tile
    qp = torch.nn.functional.pad(gq, (0, 0, 0, bpad - b))
    dbp = torch.nn.functional.pad(gcodes, (0, 0, 0, npad - n))
    chunk = M1_LIB_CHUNK // tile * tile

    def library(slice_add: bool):
        acc = torch.zeros((bpad, M1_NB_OUT), dtype=torch.int32, device=gq.device)
        for r0 in range(0, npad, chunk):
            cross = torch._int_mm(qp, dbp[r0 : r0 + chunk].T)
            if slice_add:
                acc += cross.view(bpad, -1, tile)[:, :, :M1_NB_OUT].sum(1, dtype=torch.int32)
        return acc

    require(bool(torch.equal(library(True), got[0])), f"torch._int_mm path differs at n={n}")
    bound, by = m1_bound_ms(bpad, npad, d, M1_NB_OUT, b, n)
    by_kernel = device_ms_by_kernel(lambda: mp.mm_probe(gq, gcodes, **kw), 5)
    return {"b": b, "bpad": bpad, "n": n, "npad": npad, "d": d, "tile": tile,
            "nb_out": M1_NB_OUT, "max_abs_err": err, "mismatches": mism,
            "match": "bit-identical (out and all-column row sum)",
            "ms": cuda_ms(lambda: mp.mm_probe(gq, gcodes, **kw), reps),
            "device_ms_kernel_alone": named(by_kernel, "mm_probe_kernel"),
            "plain_ms": cuda_ms(lambda: mp.mm_probe_ref(gq, gcodes, **kw), 1),
            "bound_ms": bound, "bound_by": by,
            "library_ms": cuda_ms(lambda: library(False), 3),
            "library_with_slice_add_ms": cuda_ms(lambda: library(True), 3)}


def m1_equal(q, db, tile: int, nb_out: int, what: str) -> None:
    """M1 on card tensors bit-identical to its plain version (both outputs)."""
    import torch

    from diskrag_tpu_torch.ops import mm_probe as mp

    got = mp.mm_probe(q, db, tile=tile, nb_out=nb_out)
    want = mp.mm_probe_ref(q, db, tile=tile, nb_out=nb_out)
    torch.cuda.synchronize()
    require(bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])),
            f"M1 differs from its plain version at {what}")


def phase_m1_kernels(smi: str, sets: dict) -> dict:
    """M1 against its plain version at the micro script's shapes (B = 1000,
    D = 128, 200k and 1M rows, tiles 2048 and 4096, nb_out 512; at 200k also
    B = 1 and 37), at a ragged one (B, n and D no multiples of anything,
    tile 272: a column block across two tiles) and where every sum wraps
    (codes -128, tile 64, 1100 tiles). Returns M1's entry of the kernels
    line, without its launches."""
    import torch

    cases = []
    for n_pts in (CMP_N, MAIN_N):
        pts, q, _ = sets[n_pts]
        gcodes, _, gq, _, _ = packed_codes(pts, q)
        for tile in (2048, 4096):
            case = m1_case(gq, gcodes, tile, reps=20)
            cases.append(case)
            emit({"phase": "kernels", "kernel": "M1", "card": smi, **case})
            if n_pts == CMP_N:
                for b in (1, 37):
                    m1_equal(gq[:b], gcodes, tile, M1_NB_OUT, f"b={b} n={n_pts} tile={tile}")
        del gcodes, gq
        torch.cuda.empty_cache()
    g = torch.Generator(device="cpu").manual_seed(11)
    rq = torch.randint(-127, 128, (37, 44), generator=g, dtype=torch.int8).cuda()
    rdb = torch.randint(-127, 128, (5003, 44), generator=g, dtype=torch.int8).cuda()
    m1_equal(rq, rdb, 272, 100, "the ragged shape")
    wq = torch.full((37, 128), -128, dtype=torch.int8, device="cuda")
    wdb = torch.full((64 * 1100, 128), -128, dtype=torch.int8, device="cuda")
    m1_equal(wq, wdb, 64, 64, "the wrapping shape")
    emit({"phase": "kernels", "kernel": "M1", "cases": [
        {"case": "ragged", "b": 37, "n": 5003, "d": 44, "tile": 272, "nb_out": 100},
        {"case": "wraps (codes -128: column sums 2.3e9, row sums 1.5e11)", "b": 37,
         "n": 70400, "d": 128, "tile": 64, "nb_out": 64},
        {"case": "small batches", "b": [1, 37], "n": CMP_N, "tile": [2048, 4096]}],
        "match": "bit-identical (out and all-column row sum)"})
    main_case = next(c for c in cases if c["n"] == MAIN_N and c["tile"] == 2048)
    return {"name": "M1 mm_probe (the packed scans' product, fold taken out)",
            "route": "cuda", "source": "diskrag_tpu_torch/csrc/mm_probe.cu",
            "replaces": "benchmarks/fused_scan_micro.py:164",
            **{k: main_case[k] for k in ("max_abs_err", "match", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms", "library_with_slice_add_ms",
                                         "device_ms_kernel_alone")},
            "shape": {k: main_case[k] for k in ("b", "bpad", "n", "npad", "d", "tile", "nb_out")},
            "all_shapes": cases}


def micro_expected(stage: str) -> tuple:
    """The kernels a stage of the micro script is named for."""
    if stage.startswith("scan_mm_only"):
        return ("M1",)
    if stage.startswith("scan_only_hier_pipe"):
        return ("B6",)
    if stage.startswith("scan_only_hier"):
        return ("B3",)
    if stage in ("scan_only_int8", "scan_only_bf16"):
        return ("B1",)
    if stage == "fused_full_int8":
        return ("B1", "B4")
    if stage.startswith(("scan_only_packed", "fused_full_packed", "fused_full_table")):
        return ("B2",)  # 200k rows: the plan routes to the flat packed fold, cut fused
    if stage.startswith(("rerank_", "tail_cut")):
        return ("B4",)
    return ()


def phase_micro(smi: str, sets: dict) -> int:
    """The port's fused-scan microbenchmark, called in process: every stage
    at 200k rows, the M1 and hierarchical stages at 1M (where B3 serves).
    Every stage must have launched exactly the kernels it is named for,
    once per call. Then a packed scan's time beside M1's at the same rows,
    on the host clock (stages) and on the device by kernel name: M1 runs
    the product of B2 / B3's partial kernel with the fold taken out, so the
    partial kernel's device time less M1's is what their fold costs (and,
    at 1M, B6's partial kernel less M1's what B6's fold and turns cost).
    Returns M1's launches over the phase, the counts having been set to 0
    before each stage and read after it."""
    import torch

    from diskrag_tpu_torch.ops import flat_scan as fs
    from diskrag_tpu_torch.ops import mm_probe as mp
    from diskrag_tpu_torch.tools import fused_scan_micro

    m1_launches = 0
    ms: dict = {}
    for n_pts, only in ((CMP_N, None), (MAIN_N, ("scan_mm_only", "scan_only_hier_p"))):
        lines = fused_scan_micro.run(
            data=sets[n_pts], k=MAIN_K, repeats=3, min_seconds=0.2, only=only, device="cuda",
            emit=lambda line, n=n_pts: emit({"phase": "micro", "n": n, **line}))
        names = [ln["stage"] for ln in lines]
        require(len(names) == (22 if only is None else 6), f"micro stages at n={n_pts}: {names}")
        for ln in lines:
            want = {kid: ln["calls"] for kid in micro_expected(ln["stage"])}
            require(ln["launches"] == want,
                    f"micro stage {ln['stage']} at n={n_pts} launched {ln['launches']}, "
                    f"expected {want}")
            if ln["stage"].startswith("fused_full"):  # the bench's gate for the fused paths
                require(ln["recall"] >= 0.96, f"micro stage {ln['stage']}: recall {ln['recall']}")
            ms[n_pts, ln["stage"]] = ln["batch_ms"]
            m1_launches += ln["launches"].get("M1", 0)
    require(m1_launches > 0, "the scan_mm_only stages did not launch M1")
    # the same split on the device alone, by kernel name, at both sizes
    split = {}
    for n_pts, scan, part in ((CMP_N, fs.scan_bucketed_topk_packed, "packed_scan_merge"),
                              (MAIN_N, fs.scan_bucketed_topk_hier, "hier_scan_merge")):
        pts, q, _ = sets[n_pts]
        gcodes, gscale, gq, gqs, norms = packed_codes(pts, q)
        k_scan = device_ms_by_kernel(lambda: scan(gq, gqs, gcodes, norms, gscale), 5)
        k_mm = device_ms_by_kernel(lambda: mp.mm_probe(gq, gcodes, tile=2048, nb_out=512), 5)
        stage = "scan_only_packed" if n_pts == CMP_N else "scan_only_hier_plain_nb512_t2048"
        split[str(n_pts)] = {
            "scan": "B2" if n_pts == CMP_N else "B3",
            "scan_stage_ms": ms[n_pts, stage], "mm_only_stage_ms": ms[n_pts, "scan_mm_only_t2048"],
            "fold_ms": ms[n_pts, stage] - ms[n_pts, "scan_mm_only_t2048"],
            "device_scan_partial_ms": named(k_scan, "packed_wgmma_partial"),
            "device_merge_ms": named(k_scan, part),
            "device_mm_probe_kernel_ms": named(k_mm, "mm_probe_kernel"),
            "device_partial_less_probe_ms": (
                named(k_scan, "packed_wgmma_partial") - named(k_mm, "mm_probe_kernel")
                if k_scan and k_mm else None),
        }
        if n_pts == MAIN_N:
            k_b6 = device_ms_by_kernel(
                lambda: scan(gq, gqs, gcodes, norms, gscale, pipelined=True), 5)
            split[str(n_pts)].update({
                "device_b6_partial_ms": named(k_b6, "pingpong_wgmma_partial"),
                "device_b6_partial_less_probe_ms": (
                    named(k_b6, "pingpong_wgmma_partial") - named(k_mm, "mm_probe_kernel")
                    if k_b6 and k_mm else None)})
        del gcodes, gq, norms
        torch.cuda.empty_cache()
    emit({"phase": "micro", "derived": "packed scan ms - matmul-only ms, same rows",
          "note": "M1 runs B2 / B3's partial kernel with the fold taken out (same block, TMA ring "
                  "and wgmma): device_partial_less_probe_ms is what the fold costs",
          "by_rows": split, "m1_launches": m1_launches, "card": smi})
    return m1_launches


def write_metadata(base, name: str, n_rows: int) -> None:
    """A metadata table for collection `name` (one FAQ row per vector), so
    results carry texts. The table of a size is written once under `base`
    and copied to every collection of that size."""
    import numpy as np
    import pandas as pd

    from diskrag_tpu_torch.data import CollectionManager, get_text_hash

    table = base / ".metadata" / f"{n_rows}.parquet"
    if not table.exists():
        table.parent.mkdir(parents=True, exist_ok=True)
        texts = [f"document {i}" for i in range(n_rows)]
        pd.DataFrame({
            "text": texts, "text_hash": [get_text_hash(t) for t in texts],
            "vector_index": np.arange(n_rows, dtype=np.int64),
            "metadata": [json.dumps({"type": "faq", "qa_id": f"q{i}", "question": t,
                                     "answer": f"answer {i}"}) for i, t in enumerate(texts)],
        }).to_parquet(table, index=False)
    shutil.copyfile(table, CollectionManager(base).get_metadata_path(name))


def concurrent_search_batches(state, name: str, n_requests: int = 8,
                              queries_each: int = 16) -> dict:
    """`n_requests` /search-batch requests to collection `name` on a socket
    on 127.0.0.1, each of its own `queries_each` text queries: first one
    after the other (each alone), then all at once, the launch counts set
    to 0 before each and read after. Every concurrent response must carry
    the ids and distances of the same request sent alone, both ways must
    launch the same kernels, and a graph collection B5 once per traversal
    round its responses report. Returns both wall times."""
    import asyncio

    import aiohttp
    from aiohttp import web

    from diskrag_tpu_torch.api import create_app

    payloads = [{"collection": name, "top_k": 5,
                 "queries": [f"concurrent request {j} query {i}" for i in range(queries_each)]}
                for j in range(n_requests)]
    got: dict = {}

    async def exchange() -> None:
        runner = web.AppRunner(create_app(state))
        await runner.setup()
        try:
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            url = f"http://127.0.0.1:{runner.addresses[0][1]}/search-batch"
            async with aiohttp.ClientSession() as session:
                async def post(payload):
                    async with session.post(url, json=payload) as resp:
                        return resp.status, await resp.json()

                reset_counts()
                t = time.perf_counter()
                got["alone"] = [await post(p) for p in payloads]
                got["alone_s"] = time.perf_counter() - t
                got["alone_launches"] = read_counts()
                reset_counts()
                t = time.perf_counter()
                got["together"] = await asyncio.gather(*(post(p) for p in payloads))
                got["together_s"] = time.perf_counter() - t
                got["together_launches"] = read_counts()
        finally:
            await runner.cleanup()

    asyncio.run(exchange())
    rounds = 0
    for j, ((st_a, alone), (st_t, together)) in enumerate(zip(got["alone"], got["together"])):
        require(st_a == st_t == 200, f"{name}: request {j} answered {st_a} alone, {st_t} at once")
        for body in (alone, together):
            require(len(body["results"]) == queries_each, f"{name}: request {j} lost results")
        (ai, ad), (ti, td) = _result_lists(alone), _result_lists(together)
        require(ai == ti and ad == td,
                f"{name}: request {j} sent with the others differs from it sent alone")
        require(alone["stats"].get("rounds") == together["stats"].get("rounds"),
                f"{name}: request {j} took other rounds at once")
        rounds += alone["stats"].get("rounds", 0)
    kind = got["alone"][0][1]["stats"]["search_type"]
    launches = got["alone_launches"]
    others = {k: v for k, v in launches.items() if k != "B5"}
    require(got["together_launches"] == launches and any(launches.values())
            and (not rounds or (launches["B5"] == rounds and not any(others.values()))),
            f"{name}: the requests launched {launches} alone, {got['together_launches']} at "
            f"once ({rounds} rounds)")
    return {"collection": name, "search_type": kind, "requests": n_requests,
            "queries_each": queries_each, "ids": "each concurrent response equal to it sent alone",
            "wall_ms_one_after_another": got["alone_s"] * 1e3,
            "wall_ms_all_at_once": got["together_s"] * 1e3,
            "rounds_each_way": rounds, "launches_each_way": launches}


def phase_api(smi: str, base, name: str, n_rows: int) -> None:
    """The HTTP API over the vamana collection that `phase_main_vamana`
    built and served, on a socket on 127.0.0.1 (an ephemeral port). The
    collection gets a metadata table (one FAQ row per vector) so results
    carry texts. Requests are sent one after the other; queries are texts
    embedded by the mock embedder (hash-seeded vectors), so this checks
    the plumbing and the launch path, not ranking."""
    import asyncio

    import aiohttp
    import numpy as np
    from aiohttp import web

    from diskrag_tpu_torch.api import AppState, create_app
    from diskrag_tpu_torch.data import EmbeddingConfig, EmbeddingGenerator

    write_metadata(base, name, n_rows)
    cfg = EmbeddingConfig(provider="mock", model="mock", dimension=MAIN_D)
    state = AppState(base_dir=str(base), embedding_config=cfg,
                     llm_fn=lambda system, prompt: "smoke answer", device="cuda")
    state.embedder = EmbeddingGenerator(cfg, cache_dir=base / ".embeddings")
    state.prepare()
    engine = state.get_engine(name)  # bring-up (load, self-check) before the counted requests
    queries = [f"how do I use feature {i}?" for i in range(64)]
    sent: list = []

    async def exchange() -> None:
        runner = web.AppRunner(create_app(state))
        await runner.setup()
        try:
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            url = f"http://127.0.0.1:{runner.addresses[0][1]}"
            for method, path, payload in (
                ("GET", "/health", None), ("GET", "/collections", None),
                ("POST", "/search", {"collection": name, "query": queries[0], "top_k": 5}),
                ("POST", "/faq-search", {"collection": name, "query": queries[1], "top_k": 3}),
                ("POST", "/search-batch", {"collection": name, "queries": queries, "top_k": 5}),
                ("POST", "/ask", {"collection": name, "question": queries[2], "top_k": 2}),
            ):
                t = time.perf_counter()
                async with aiohttp.request(method, url + path, json=payload) as resp:
                    sent.append((path, resp.status, await resp.json(),
                                 (time.perf_counter() - t) * 1e3))
        finally:
            await runner.cleanup()

    reset_counts()
    asyncio.run(exchange())
    launches = read_counts()
    for path, status, _, _ in sent:
        require(status == 200, f"{path} answered {status}")
    body = {path: data for path, _, data, _ in sent}
    require(body["/health"]["device"]["platform"] == "gpu", f"/health: {body['/health']}")
    entry = next(e for e in body["/collections"] if e["name"] == name)
    require(entry["status"] == "ready", f"/collections: {entry}")
    require(len(body["/search"]["results"]) == 5 and len(body["/faq-search"]["results"]) == 3,
            "result counts of /search and /faq-search")
    require(body["/ask"]["answer"] == "smoke answer", f"/ask: {body['/ask']}")
    # ids of /search-batch against the engine called directly on the same vectors
    qv = np.stack([state.embed(t) for t in queries]).astype(np.float32)
    _, ids, _ = engine.search_batch(qv, k=5)
    served = [[r["metadata"]["vector_index"] for r in row] for row in body["/search-batch"]["results"]]
    require(served == [[int(i) for i in row if i >= 0] for row in ids],
            "/search-batch ids differ from SearchEngine.search_batch")
    # B5 once per round: the three search responses report their rounds;
    # /ask's are those of the same query replayed on the engine
    rounds = {p: body[p]["stats"]["rounds"] for p in ("/search", "/faq-search", "/search-batch")}
    rounds["/ask"] = engine.search(queries[2], k=2, embedding_fn=state.embed)["stats"]["rounds"]
    others = {k: v for k, v in launches.items() if k != "B5"}
    require(launches["B5"] == sum(rounds.values()) > 0 and not any(others.values()),
            f"the requests launched {launches}, expected B5 {sum(rounds.values())} times")
    # what a /search-batch costs on the device: the same 64 queries through
    # search_batch at the default width, profiled
    emit(with_launches_per_round(
        profile_batch(engine, qv, steps=1, path="api-vamana-200k (search_batch of the 64 "
                      "/search-batch queries, default width)", watch=("adc_lookup_kernel",)),
        rounds["/search-batch"]))
    # concurrent requests: 8 /search-batch at once to this collection and to
    # the 200k packed flat one (phase_main_packed built it)
    flat_name = f"packed_{n_rows}"
    write_metadata(base, flat_name, n_rows)
    state.get_engine(flat_name)
    for coll in (name, flat_name):
        emit({"phase": "api", "step": "concurrent /search-batch",
              **concurrent_search_batches(state, coll), "card": smi})
    emit({"phase": "api", "collection": name, "n": n_rows, "d": MAIN_D,
          "requests": [{"path": p, "status": st, "ms": ms} for p, st, _, ms in sent],
          "search_batch_queries": len(queries), "search_batch_ids": "equal to the engine's",
          "search_type": body["/search"]["stats"]["search_type"],
          "l_search": body["/search"]["stats"]["L_search"], "rounds": rounds,
          "launches": launches, "health_device": body["/health"]["device"],
          "note": "mock-embedded text queries: plumbing and launch path, not ranking",
          "card": smi})
    del engine, state
    import torch

    torch.cuda.empty_cache()


# recall@10 gates of the host tier's 1M int8 cell, by l_search (the JAX
# package's v5e engine figures, its parity targets: 0.9916-0.9987 at L = 32,
# E = 8 and 0.9992 at L = 48)
HOST_TIER_RECALL_GATE = {32: 0.985, 48: 0.99}
HOST_TIER_JAX_RECORDED = {32: "0.9916-0.9987", 48: "0.9992"}


def _ht_drive(engine, q, gt, l_search: int, reps: int = 5) -> dict:
    """One warm-up `search_batch`, then `reps` timed ones with every launch
    count set to 0 just before and read just after."""
    import numpy as np

    from diskrag_tpu_torch.benchmark import recall_at_k

    engine.search_batch(q, k=MAIN_K, l_search=l_search)
    cache0 = engine.host_tier.reader.cache_stats()
    dists, ids, all_stats, batch_s, launches = drive(engine, q, reps, l_search=l_search)
    cache1 = engine.host_tier.reader.cache_stats()
    stats = all_stats[-1]
    require(ids.shape == (len(q), MAIN_K) and bool(np.isfinite(dists).all())
            and bool((np.diff(dists, axis=1) >= 0).all()), "host-tier distances not finite and ascending")
    require(stats["search_type"] == "host_tier", f"served as {stats['search_type']}")
    med = float(np.median(batch_s))
    return {
        "l_search": l_search, "expand_width": stats["expand_width"],
        "recall_at_10": recall_at_k(ids, gt, MAIN_K),
        "ms_per_batch_median": med * 1e3, "ms_per_batch_min": min(batch_s) * 1e3,
        "ms_per_batch_max": max(batch_s) * 1e3, "qps": len(q) / med,
        "stage_ms": stats["stage_ms"], "rounds_per_batch": sum(s["rounds"] for s in all_stats) / reps,
        "pipelined_chunks": stats.get("pipelined_chunks", 1),
        "nodes_visited": stats["nodes_visited"],
        "host_vectors_fetched": stats["host_vectors_fetched"],
        "reader_cache_hits": cache1["hits"] - cache0["hits"],
        "reader_cache_misses": cache1["misses"] - cache0["misses"],
        "launches": launches, "_ids": ids, "_rounds": sum(s["rounds"] for s in all_stats),
    }


def _ht_search_ms(ht, q, reps: int, **kw) -> tuple[list, object, dict]:
    """Host ms of `reps` calls of `HostTierIndex.search` (`pipelined` in kw
    picks `search_pipelined`), after one warm-up; (times, ids, stats)."""
    fn = ht.search_pipelined if kw.pop("pipelined", False) else ht.search
    fn(q, **kw)
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        _, ids, stats = fn(q, **kw)
        times.append((time.perf_counter() - t) * 1e3)
    return times, ids, stats


def phase_host_tier_1m(smi: str, base, pts, q, gt) -> dict:
    """Cell host-tier-1M-iq8, as the JAX bench's host-tier stage builds it:
    the degree-48 graph (B1 and B4 in its kNN pass), `IntQuantizer(bits=8)`
    fit and encoded, `save_index(write_compat=True)` with the tuned L = 32 /
    E = 8, then served by `SearchEngine(serving_mode="host_tier")`: int8
    rows and the graph on the card, the f32 vectors in the record file,
    the rerank on the host. The iq traversal reaches no kernel. Before the
    quantizer, G1 is held against the plain rounds on the graph at the
    exact cell's shapes (`g1_rows`, `G1_CELL_SHAPES`)."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.engine import SearchEngine
    from diskrag_tpu_torch.graph.knn_build import build_vamana_knn
    from diskrag_tpu_torch.index.host_tier import HostTierIndex
    from diskrag_tpu_torch.index.persist import save_index
    from diskrag_tpu_torch.pq.intq import IntQuantizer

    name = "host_tier_1m"
    index_dir = make_collection(base, name, pts)
    stages: dict = {}
    seconds: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    index = build_vamana_knn(pts, degree_bound=48, alpha=1.2, seed=0, device="cuda",
                             stage_seconds=stages)
    torch.cuda.synchronize()
    seconds["build"] = time.perf_counter() - t0
    build_launches = read_counts()
    require(build_launches["B1"] > 0 and build_launches["B4"] == build_launches["B1"],
            f"the 1M graph build did not go through B1 and B4: {build_launches}")
    g1 = g1_rows(smi, index, q, gt, G1_CELL_SHAPES, f"{len(pts) // 1000}k R48")
    g2 = g2_rows(smi, index, q, G2_CELL_SHAPES, f"{len(pts) // 1000}k R48")
    t0 = time.perf_counter()
    iq8 = IntQuantizer(bits=8, device="cuda").fit(pts, seed=0)
    torch.cuda.synchronize()
    seconds["fit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes = iq8.encode(pts)
    seconds["encode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_index(index_dir, index, pq=iq8, pq_codes=codes,
               meta_extra={"recommended_search_L": 32, "recommended_expand_width": 8},
               write_compat=True, host_vectors=pts)
    seconds["save"] = time.perf_counter() - t0
    del index, iq8, codes
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    engine = SearchEngine(name, base_dir=str(base), serving_mode="host_tier", device="cuda")
    seconds["engine_load_and_self_check"] = time.perf_counter() - t0
    ht = engine.host_tier
    require(ht.mode == "iq" and ht.reader.is_native,
            f"host tier picked mode {ht.mode}, native reader {ht.reader.is_native}")
    require(bool(engine.diagnostics and engine.diagnostics["passed"]),
            f"startup diagnostic failed: {engine.diagnostics}")
    points, ids_at = [], {}
    for l_search in (32, 48):
        row = _ht_drive(engine, q, gt, l_search)
        ids_at[l_search] = row.pop("_ids")
        row.pop("_rounds")
        require(not any(row["launches"].values()),
                f"the iq traversal launched a kernel: {row['launches']}")
        gate = HOST_TIER_RECALL_GATE[l_search]
        require(row["recall_at_10"] >= gate,
                f"host-tier 1M recall@10 {row['recall_at_10']} < {gate} at L={l_search}")
        row.update(recall_gate=gate, jax_package_recorded=HOST_TIER_JAX_RECORDED[l_search])
        points.append(row)
    emit({"phase": "main-host-tier", "cell": "host-tier-1M-iq8", "n": len(pts), "d": pts.shape[1],
          "queries": len(q), "k": MAIN_K, "degree_bound": 48, "mode": ht.mode,
          "reader_native": ht.reader.is_native, "points": points, "seconds": seconds,
          "build_stage_seconds": stages, "build_launches": build_launches,
          "device_bytes_tier": ht.device_bytes(), "host_f32_bytes": int(pts.nbytes),
          "device_allocated_bytes": torch.cuda.memory_allocated(), "card": smi})
    rounds32 = points[0]["rounds_per_batch"]
    emit(with_launches_per_round(
        profile_batch(engine, q, steps=2, path="host-tier-1M-iq8", l_search=32,
                      watch=("gemm", "bmm")), rounds32))

    # the same queries through HostTierIndex.search and search_pipelined
    # (chunk 500, the engine's), alternating, at L = 32 / E = 8
    kw = dict(search_width=32, k=MAIN_K, expand_width=8)
    seq_a, ids_seq, st_seq = _ht_search_ms(ht, q, 3, **kw)
    pip_a, ids_pip, st_pip = _ht_search_ms(ht, q, 3, pipelined=True, chunk=500, **kw)
    seq_b, _, _ = _ht_search_ms(ht, q, 3, **kw)
    pip_b, _, _ = _ht_search_ms(ht, q, 3, pipelined=True, chunk=500, **kw)
    require(bool(np.array_equal(ids_seq, ids_pip)), "search_pipelined ids differ from search")
    require(bool(np.array_equal(ids_pip, ids_at[32])), "the engine's ids differ from search_pipelined")
    emit({"phase": "main-host-tier", "cell": "host-tier-1M-iq8", "compare": "search vs search_pipelined",
          "l_search": 32, "expand_width": 8, "chunk": 500,
          "search_ms": seq_a + seq_b, "search_pipelined_ms": pip_a + pip_b,
          "search_stage_ms": st_seq["stage_ms"], "search_pipelined_stage_ms": st_pip["stage_ms"],
          "ids": "equal", "order": "search, pipelined, search, pipelined", "card": smi})

    # the 256-byte gather pad: the same tier without it, rounds timed
    # alternately on the same queries
    bare = HostTierIndex.from_store(engine.manager.get_index_dir(name), gather_pad=False,
                                    device="cuda")
    require(bare.guide.codes.shape[1] == 130 and ht.guide.codes.shape[1] == 256,
            "gather pad widths")
    rows = {}
    for label, tier in (("padded_256", ht), ("unpadded_130", bare), ("padded_256_again", ht),
                        ("unpadded_130_again", bare)):
        times, ids, st = _ht_search_ms(tier, q, 3, **kw)
        rows[label] = {"search_ms": times, "traverse_and_fetch_ms": st["stage_ms"]["traverse_and_fetch"],
                       "rounds": st["rounds"]}
        require(bool(np.array_equal(ids, ids_seq)), f"{label}: ids differ with the pad")
    emit({"phase": "main-host-tier", "cell": "host-tier-1M-iq8", "compare": "gather pad",
          "l_search": 32, "expand_width": 8, **rows, "ids": "equal", "card": smi})
    del engine, ht, bare
    torch.cuda.empty_cache()
    shutil.rmtree(base / name, ignore_errors=True)  # 2 GB of files no later phase reads
    return {"build_launches": build_launches, "g1": g1, "g2": g2}


# The JAX package's capacity ladder (`benchmarks/host_tier_multi.py`): each
# quantizer's traversal mode and search widths (its QUANT_SPECS), served at
# E = 8 over one R = 32 graph built with the record file
LADDER_SPECS = {"iq8": ("iq", (24, 32, 48)), "iq4c1024": ("iq", (32, 48, 64, 96)),
                "rpq64": ("pq", (48, 64, 96, 128))}
# recall@10 the JAX package recorded on the same data
# (`benchmarks/last_host_tier_multi_{1000000,10000000}.json`, E = 8): the
# gates are these less 0.01; at 10M the ladder serves iq8 and rpq64, as there
LADDER_JAX_RECALL = {
    1_000_000: {"iq8": {24: 0.9891, 32: 0.9916, 48: 0.9940},
                "iq4c1024": {32: 0.7971, 48: 0.8759, 64: 0.9184, 96: 0.9631},
                "rpq64": {48: 0.9899, 64: 0.9941, 96: 0.9965, 128: 0.9980}},
    10_000_000: {"iq8": {24: 0.9765, 32: 0.9822, 48: 0.9862},
                 "rpq64": {48: 0.9634, 64: 0.9787, 96: 0.9887, 128: 0.9919}},
}
LADDER_TEN_M = 10_000_000


def _ladder_quantizer(tag: str):
    """An unfitted quantizer of the ladder, as `host_tier_multi.py::
    train_quantizer` makes it."""
    from diskrag_tpu_torch.pq import IntQuantizer, ResidualPQ

    if tag == "iq8":
        return IntQuantizer(bits=8, device="cuda")
    if tag == "iq4c1024":
        return IntQuantizer(bits=4, n_cells=1024, device="cuda")
    return ResidualPQ(n_subvectors=int(tag[3:]), device="cuda")


@contextlib.contextmanager
def _captured_b5_round(round_index: int):
    """The operands of the `round_index`-th call of B5 by id made inside
    the block (a traversal round's real tables, code table, ids and
    residual operands), kept as the wrapper received them."""
    from diskrag_tpu_torch.ops import pq_scan

    real = pq_scan.adc_lookup_ids_kernel
    got: dict = {}
    calls = [0]

    def keep(tables, code_table, ids, **aux):
        if calls[0] == round_index:
            got.update(tables=tables, code_table=code_table, ids=ids.clone(), aux=dict(aux))
        calls[0] += 1
        return real(tables, code_table, ids, **aux)

    pq_scan.adc_lookup_ids_kernel = keep
    try:
        yield got
    finally:
        pq_scan.adc_lookup_ids_kernel = real


def ladder_b5_rows(op: dict, smi: str, cell: str) -> dict:
    """B5 by id at one rpq64 round's real operands, bit for bit against its
    plain version and timed beside its bound; below 10M rows also the same
    round lifted onto a code table of 10M rows (the round's table repeated,
    each id moved to a random copy of its row): the plain version's values,
    and the values of the round at its own table, bit for bit."""
    import torch

    from diskrag_tpu_torch.ops import pq_scan

    tables, codes, ids, aux = op["tables"], op["code_table"], op["ids"], op["aux"]
    n = codes.shape[0]
    out = {"real_round": {"rows": n, **_b5_compact(b5_ids_row(tables, codes, ids, aux))}}
    emit({"phase": "main-host-tier-ladder", "cell": cell, "kernel": "B5", "operands": "one rpq64 round",
          **out["real_round"], "card": smi})
    if n < LADDER_TEN_M and LADDER_TEN_M % n == 0:
        reps = LADDER_TEN_M // n
        g = torch.Generator(device=ids.device).manual_seed(7)
        ids10 = ids + n * torch.randint(0, reps, tuple(ids.shape), generator=g, device=ids.device)
        codes10 = codes.repeat(reps, 1)
        aux10 = {"point_cell": aux["point_cell"].repeat(reps),
                 "point_bias": aux["point_bias"].repeat(reps), "cell_tables": aux["cell_tables"]}
        same = torch.equal(pq_scan.adc_lookup_ids_kernel(tables, codes10, ids10, **aux10),
                           pq_scan.adc_lookup_ids_kernel(tables, codes, ids, **aux))
        require(same, f"B5 over a {LADDER_TEN_M}-row table differs from the same rows at {n}")
        out["lifted_10m"] = {"rows": LADDER_TEN_M, "max_id": int(ids10.max()),
                             "equal_to_own_table": True,
                             **_b5_compact(b5_ids_row(tables, codes10, ids10, aux10))}
        emit({"phase": "main-host-tier-ladder", "cell": cell, "kernel": "B5",
              "operands": "one rpq64 round lifted onto a 10M-row code table",
              **out["lifted_10m"], "card": smi})
        del codes10, aux10, ids10
        torch.cuda.empty_cache()
    return out


def phase_host_tier_ladder(smi: str, base, pts, q, gt) -> dict:
    """Cell host-tier-1M-R32-ladder (at 10M, host-tier-10M): the JAX
    package's capacity ladder (`benchmarks/host_tier_multi.py`) through the
    port's own modules. `build_vamana_knn(degree_bound=32, knn_probe=8)`
    (the flat kNN backend, B1 + B4, up to 2M points; above, the IVF
    backend with 65,536 random entry points and no kernel), with a
    checkpoint directory; `save_index(write_compat=True)`; then each
    quantizer trained, swapped in (`persist.replace_pq_artifacts`: the pq
    family's meta keys replaced, not merged), opened by
    `HostTierIndex.from_store(mode=...)` and searched on the whole query
    batch at its widths, E = 8, 3 timed calls after a warm-up (the JAX
    bench's repeats; the fastest is reported, as there), with
    the launch counts set to 0 just before and read just after: B5 once a
    round in the rpq64 rows, no kernel in the iq rows. Recall@10 is gated
    at the JAX package's figure less 0.01 where it recorded one at this N.
    B5 is held at one rpq64 round's real operands (`ladder_b5_rows`)."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.benchmark import recall_at_k
    from diskrag_tpu_torch.graph.knn_build import build_vamana_knn
    from diskrag_tpu_torch.index.host_tier import HostTierIndex
    from diskrag_tpu_torch.index.persist import replace_pq_artifacts, save_index

    n = len(pts)
    reps = 3
    recorded = LADDER_JAX_RECALL.get(n, {})
    quantizers = tuple(recorded) or tuple(LADDER_SPECS)
    cell = "host-tier-1M-R32-ladder" if n == 1_000_000 else (
        "host-tier-10M" if n == LADDER_TEN_M else f"host-tier-{n}-R32-ladder")
    t_phase = time.perf_counter()
    index_dir = base / "host_tier_ladder" / "index"
    ckpt = ROOT / "build" / "chip_smoke" / f"ladder_checkpoint_{n}"
    index_dir.mkdir(parents=True, exist_ok=True)
    seconds: dict = {}
    stages: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    index = build_vamana_knn(pts, degree_bound=32, knn_probe=8, seed=0, device="cuda",
                             checkpoint_dir=str(ckpt), stage_seconds=stages)
    torch.cuda.synchronize()
    seconds["build"] = time.perf_counter() - t0
    build_launches = read_counts()
    if n <= 2_000_000:
        require(build_launches["B1"] == build_launches["B4"] == -(-n // 4096),
                f"the R = 32 build did not go through B1 and B4 once a block: {build_launches}")
    else:
        require(build_launches["B1"] == build_launches["B4"] == 0,
                f"the IVF-backend R = 32 build launched B1 / B4: {build_launches}")
    n_entry = 0 if index.entry_points is None else int(index.entry_points.shape[0])
    t0 = time.perf_counter()
    save_index(index_dir, index, write_compat=True, host_vectors=pts)
    seconds["save"] = time.perf_counter() - t0
    del index
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    record_bytes = (index_dir / "index.dat").stat().st_size
    peaks = stages.pop("peak_device_bytes", {})
    emit({"phase": "main-host-tier-ladder", "cell": cell, "step": "build", "n": n,
          "d": pts.shape[1], "degree_bound": 32, "knn_probe": 8,
          "knn_backend": "flat" if n <= 2_000_000 else "ivf", "entry_points": n_entry,
          "seconds": seconds, "stage_seconds": stages, "peak_device_bytes_by_stage": peaks,
          "launches": build_launches, "record_file_bytes": record_bytes,
          "host_f32_bytes": int(pts.nbytes), "card": smi})

    rows, quant, b5_rows = [], {}, None
    for tag in quantizers:
        mode, widths = LADDER_SPECS[tag]
        qs: dict = {}
        pq = _ladder_quantizer(tag)
        t0 = time.perf_counter()
        pq.fit(pts, seed=0)
        torch.cuda.synchronize()
        qs["fit_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        enc = pq.encode(pts)
        torch.cuda.synchronize()
        qs["encode_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if mode == "pq":
            meta = replace_pq_artifacts(index_dir, pq, enc[0], coarse_ids=enc[1])
        else:
            meta = replace_pq_artifacts(index_dir, pq, enc)
        qs["swap_seconds"] = time.perf_counter() - t0
        stale = sorted(set(meta) & ({"n_subvectors", "pq_centroids", "pq_n_coarse"} if mode == "iq"
                                    else {"iq_row_width", "iq_n_cells"}))
        require(not stale and (index_dir / "pq_aux.npz").exists() == (mode == "pq"),
                f"{tag}: stale meta keys {stale} after the swap")
        del pq, enc
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ht = HostTierIndex.from_store(index_dir, mode=mode, device="cuda")
        qs["open_seconds"] = time.perf_counter() - t0
        require(ht.mode == mode and ht.reader.is_native,
                f"{tag}: served mode {ht.mode}, native reader {ht.reader.is_native}")
        # the payload a point, as the JAX bench counts it: the int row's
        # own width (not the 256-byte gather pad); the codes and the
        # residual PQ's cell id and bias
        bpp = int(ht.guide.pq.row_width) if mode == "iq" else (
            int(ht.guide.codes.shape[1]) + (8 if ht.guide.cells is not None else 0))
        qs.update(device_bytes_tier=ht.device_bytes(),
                  device_allocated_bytes=torch.cuda.memory_allocated(),
                  bytes_per_point=bpp, meta_kind=meta["pq_kind"])
        quant[tag] = qs
        for width in widths:
            kw = dict(search_width=width, k=MAIN_K, expand_width=8)
            ht.search(q, **kw)
            reset_counts()
            times, rounds, out = [], 0, None
            for _ in range(reps):
                t0 = time.perf_counter()
                dists, ids, st = ht.search(q, **kw)
                times.append((time.perf_counter() - t0) * 1e3)
                rounds += st["rounds"]
                if out is None or times[-1] == min(times):
                    out = st
            launches = read_counts()
            require(ids.shape == (len(q), MAIN_K) and bool(np.isfinite(dists).all())
                    and bool((np.diff(dists, axis=1) >= 0).all()),
                    f"{tag} L={width}: distances not finite and ascending")
            others = {k: v for k, v in launches.items() if k != "B5"}
            if mode == "pq":
                require(launches["B5"] == rounds > 0 and not any(others.values()),
                        f"{tag} L={width}: expected {rounds} B5 launches (one a round), got {launches}")
            else:
                require(not any(launches.values()), f"{tag} L={width}: the iq traversal launched {launches}")
            rec = recall_at_k(ids, gt, MAIN_K)
            row = {"quantizer": tag, "mode": mode, "R": 32, "L": width, "E": 8,
                   "bytes_per_point": bpp, "recall_at_10": rec,
                   "ms_per_batch_min": min(times), "ms_per_batch_median": float(np.median(times)),
                   "ms_per_batch": times, "qps": len(q) * 1e3 / min(times),
                   "stage_ms": out["stage_ms"], "rounds_per_batch": rounds / reps,
                   "nodes_visited": out["nodes_visited"],
                   "host_vectors_fetched": out["host_vectors_fetched"], "launches": launches,
                   "device_bytes_tier": qs["device_bytes_tier"], "host_f32_bytes": int(pts.nbytes)}
            if tag in recorded:
                gate = round(recorded[tag][width] - 0.01, 4)
                require(rec >= gate, f"{cell} {tag} recall@10 {rec} < {gate} at L={width}")
                row.update(recall_gate=gate, jax_package_recorded=recorded[tag][width])
            rows.append(row)
            emit({"phase": "main-host-tier-ladder", "cell": cell, **row, "card": smi})
        if mode == "pq":
            # one round's real operands (the third round of a search at the
            # narrowest width: 1000 queries x E * R = 256 candidates)
            with _captured_b5_round(2) as op:
                ht.search(q, search_width=widths[0], k=MAIN_K, expand_width=8)
            require(tuple(op["ids"].shape) == (len(q), 8 * 32), f"captured round {op['ids'].shape}")
            b5_rows = ladder_b5_rows(op, smi, cell)
            del op
        del ht
        torch.cuda.empty_cache()
    shutil.rmtree(index_dir.parent, ignore_errors=True)
    pq_rows = [r for r in rows if r["mode"] == "pq"]
    summary = {"phase": "main-host-tier-ladder", "cell": cell, "n": n, "quantizers": quant,
               "points": len(rows), "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(summary)
    return {"build_launches": {"B1": build_launches["B1"], "B4": build_launches["B4"]},
            "b5": b5_rows, "b5_launches": sum(r["launches"]["B5"] for r in pq_rows),
            "rounds": int(round(sum(r["rounds_per_batch"] * reps for r in pq_rows)))}


def phase_host_tier_200k(smi: str, base, name: str, pts, q, gt, auto_recall: float) -> dict:
    """Cells host-tier-200k-pq and host-tier-200k-bf16 over the default
    vamana collection (`phase_main_vamana` built it with its record file):
    `SearchEngine(serving_mode="host_tier")` picks the residual PQ (m = 16),
    B5 by id once a round; one HTTP /search through `create_app`; then
    `HostTierIndex.from_store(mode="bf16")` of the same directory."""
    import asyncio

    import aiohttp
    import numpy as np
    import torch
    from aiohttp import web

    from diskrag_tpu_torch.api import AppState, create_app
    from diskrag_tpu_torch.benchmark import recall_at_k
    from diskrag_tpu_torch.data import EmbeddingConfig, EmbeddingGenerator
    from diskrag_tpu_torch.engine import SearchEngine
    from diskrag_tpu_torch.index.host_tier import HostTierIndex
    from diskrag_tpu_torch.pq.residual import ResidualPQ

    engine = SearchEngine(name, base_dir=str(base), serving_mode="host_tier", device="cuda")
    ht = engine.host_tier
    require(ht.mode == "pq" and isinstance(ht.guide.pq, ResidualPQ)
            and ht.guide.pq.n_subvectors == 16,
            f"host tier over the default index picked {ht.mode} / {type(ht.guide.pq).__name__}")
    row = _ht_drive(engine, q, gt, 64)
    row.pop("_ids")
    rounds = row.pop("_rounds")
    others = {k: v for k, v in row["launches"].items() if k != "B5"}
    require(row["launches"]["B5"] == rounds > 0 and not any(others.values()),
            f"expected {rounds} launches of B5 (one a round) and no other: {row['launches']}")
    require(row["recall_at_10"] >= auto_recall - 0.01,
            f"host-tier pq recall {row['recall_at_10']} < mode auto's {auto_recall} - 0.01")
    emit({"phase": "main-host-tier", "cell": "host-tier-200k-pq", "n": len(pts), "d": pts.shape[1],
          "queries": len(q), "k": MAIN_K, "mode": ht.mode, "n_subvectors": 16,
          "auto_mode_recall_at_64": auto_recall, **row,
          "device_bytes_tier": ht.device_bytes(), "host_f32_bytes": int(pts.nbytes), "card": smi})
    emit(with_launches_per_round(
        profile_batch(engine, q, steps=2, path="host-tier-200k-pq", l_search=64,
                      watch=("adc_lookup_kernel",)), row["rounds_per_batch"]))
    # the collection got its metadata table in phase_api
    pipelined_row(smi, engine, q, "host-tier-200k-pq", expect={"B5": "rounds"}, l_search=64,
                  passes=1, profile_batches=2)

    # one HTTP /search under host_tier (the collection got its metadata
    # table in phase_api)
    cfg = EmbeddingConfig(provider="mock", model="mock", dimension=MAIN_D)
    state = AppState(base_dir=str(base), embedding_config=cfg, serving_mode="host_tier",
                     device="cuda")
    state.embedder = EmbeddingGenerator(cfg, cache_dir=base / ".embeddings")
    state.prepare()
    state.get_engine(name)
    sent: list = []

    async def exchange() -> None:
        runner = web.AppRunner(create_app(state))
        await runner.setup()
        try:
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            url = f"http://127.0.0.1:{runner.addresses[0][1]}/search"
            t = time.perf_counter()
            async with aiohttp.request("POST", url, json={
                    "collection": name, "query": "how do I use feature 3?", "top_k": 5}) as resp:
                sent.append((resp.status, await resp.json(), (time.perf_counter() - t) * 1e3))
        finally:
            await runner.cleanup()

    reset_counts()
    asyncio.run(exchange())
    launches = read_counts()
    status, body, ms = sent[0]
    require(status == 200 and len(body["results"]) == 5, f"/search under host_tier answered {status}")
    st = body["stats"]
    require(st["search_type"] == "host_tier" and launches["B5"] == st["rounds"] > 0,
            f"/search under host_tier: {st['search_type']}, B5 {launches['B5']}, rounds {st['rounds']}")
    emit({"phase": "main-host-tier", "cell": "host-tier-200k-pq", "request": "/search", "status": status,
          "ms": ms, "search_type": st["search_type"], "l_search": st["L_search"],
          "rounds": st["rounds"], "launches": launches, "card": smi})
    b5_launches = row["launches"]["B5"]
    del engine, state, ht
    torch.cuda.empty_cache()

    # bf16 traversal of the same directory
    index_dir = base / name / "index"
    bf = HostTierIndex.from_store(index_dir, mode="bf16", device="cuda")
    out = {}
    for l_search in (32, 64):
        times, ids, st = _ht_search_ms(bf, q, 3, search_width=l_search, k=MAIN_K, expand_width=4)
        out[l_search] = {"recall_at_10": recall_at_k(ids, gt, MAIN_K), "search_ms": times,
                         "stage_ms": st["stage_ms"], "rounds": st["rounds"]}
    emit({"phase": "main-host-tier", "cell": "host-tier-200k-bf16", "n": len(pts), "expand_width": 4,
          "by_l_search": out, "device_bytes_tier": bf.device_bytes(), "card": smi})
    del bf
    torch.cuda.empty_cache()
    return {"b5_launches": b5_launches, "rounds": rounds}


# recall@10 gates of the IVF cells: the JAX package's v5e int8-tile figures
# on the same seeded sets (docs/PERFORMANCE.md) less 0.01, by n_probe
IVF_RECALL_GATE = {200_000: {8: 0.9527, 16: 0.9864}, 1_000_000: {8: 0.9619, 16: 0.9795}}
IVF_JAX_RECORDED = {200_000: {8: 0.9627, 16: 0.9964}, 1_000_000: {8: 0.9719, 16: 0.9895}}


def phase_ivf(smi: str, base, pts, q, gt) -> dict:
    """Cells ivf-200k-int8 / ivf-1M-int8: `build_index_from_vectors(
    index_type="ivf")` with every default (int8 tiles, cap factor 2,
    4 sqrt(N) cells), `SearchEngine.search_batch` at l_search 16 and 32
    (n_probe 8 and 16, the engine's rule), the counts set to 0 just before
    and read just after (the IVF path has no kernel: none may launch); a
    profiled batch, the bytes the index holds on the card and the build's
    stages; then `sweep_ivf` over n_probe 8 / 16 / 32 / 64 (two builds,
    cold and warm), int8 tiles and bf16 tiles, each bf16 probe gated at
    the int8 recall less 0.01."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.benchmark import recall_at_k, sweep_ivf
    from diskrag_tpu_torch.build_index import build_index_from_vectors
    from diskrag_tpu_torch.engine import SearchEngine

    n = len(pts)
    cell = f"ivf-{n // 1000}k-int8" if n < MAIN_N else "ivf-1M-int8"
    name = f"ivf_{n}"
    index_dir = make_collection(base, name, pts)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    meta = build_index_from_vectors(pts, index_dir, index_type="ivf", device="cuda")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = SearchEngine(name, base_dir=str(base), device="cuda")
    load_s = time.perf_counter() - t0
    require(meta["index_type"] == "ivf" and meta["tile_precision"] == "int8"
            and engine.ivf is not None, f"the defaults did not build an int8 ivf index: {meta}")
    require(bool(engine.diagnostics and engine.diagnostics["passed"]),
            f"startup diagnostic failed: {engine.diagnostics}")
    points = []
    for l_search in (16, 32):
        reps = 5
        dists, ids, all_stats, batch_s, launches = drive(engine, q, reps, l_search=l_search)
        stats = all_stats[-1]
        n_probe = max(8, min(l_search // 2, engine.ivf.n_cells))
        require(stats["search_type"] == "ivf", f"served as {stats['search_type']}")
        require(not any(launches.values()), f"the IVF path launched a kernel: {launches}")
        require(ids.shape == (len(q), MAIN_K) and bool(np.isfinite(dists).all())
                and bool((np.diff(dists, axis=1) >= 0).all()), "ivf distances not finite and ascending")
        recall = recall_at_k(ids, gt, MAIN_K)
        gate = IVF_RECALL_GATE[n][n_probe]
        require(recall >= gate, f"{cell} recall@10 {recall} < {gate} at n_probe {n_probe}")
        med = float(np.median(batch_s))
        points.append({"l_search": l_search, "n_probe": n_probe, "recall_at_10": recall,
                       "recall_gate": gate, "jax_package_recorded_v5e": IVF_JAX_RECORDED[n][n_probe],
                       "ms_per_batch_median": med * 1e3, "ms_per_batch": [s * 1e3 for s in batch_s],
                       "qps": len(q) / med, "nodes_visited": stats["nodes_visited"],
                       "launches": launches})
    emit({"phase": "main-ivf", "cell": cell, "n": n, "d": pts.shape[1], "queries": len(q),
          "k": MAIN_K, "n_cells": meta["n_cells"], "cell_capacity": meta["cell_capacity"],
          "points": points, "build_seconds": build_s, "build_stage_seconds": meta["build_stage_seconds"],
          "engine_load_and_self_check_seconds": load_s,
          "device_bytes_index": engine.ivf.device_bytes(),
          "peak_device_gb_build_and_load": torch.cuda.max_memory_allocated() / 2**30, "card": smi})
    emit(profile_batch(engine, q, steps=3, path=cell, l_search=32, watch=("gemm", "sort", "index")))
    if n == MAIN_N:
        write_metadata(base, name, n)
        pipelined_row(smi, engine, q, cell, expect={}, l_search=32)
    del engine
    torch.cuda.empty_cache()
    shutil.rmtree(base / name, ignore_errors=True)
    int8_pts, (cold, warm) = sweep_ivf(pts, q, gt, k=MAIN_K, min_seconds=0.3, device="cuda")
    bf16_pts, (bf_cold, bf_warm) = sweep_ivf(pts, q, gt, k=MAIN_K, min_seconds=0.3,
                                             tile_precision="bf16", device="cuda")
    rows = []
    for a, b in zip(int8_pts, bf16_pts):
        require(a.search_width == b.search_width and b.recall >= a.recall - 0.01,
                f"bf16 tiles recall {b.recall} < int8 {a.recall} - 0.01 at n_probe {a.search_width}")
        rows.append({"n_probe": a.search_width, "recall_int8": a.recall, "recall_bf16": b.recall,
                     "qps_int8": a.qps, "qps_bf16": b.qps,
                     "ms_per_1000_queries_int8": a.mean_latency_ms * 1000,
                     "ms_per_1000_queries_bf16": b.mean_latency_ms * 1000})
    emit({"phase": "main-ivf", "cell": cell, "step": "sweep_ivf", "points": rows,
          "build_seconds_int8": {"cold": cold, "warm": warm},
          "build_seconds_bf16": {"cold": bf_cold, "warm": bf_warm}, "card": smi})
    torch.cuda.empty_cache()
    return {"points": points, "sweep": rows}


@contextlib.contextmanager
def _captured_knn_tables():
    """Wraps `approx_knn_ivf` where `build_vamana_knn` calls it and keeps
    the tables it returns (the build holds no other handle on them)."""
    from diskrag_tpu_torch.graph import knn_build as tkb

    real = tkb.approx_knn_ivf
    got: dict = {}

    def keep(*a, **k):
        got["ids"], got["dists"] = real(*a, **k)
        return got["ids"], got["dists"]

    tkb.approx_knn_ivf = keep
    try:
        yield got
    finally:
        tkb.approx_knn_ivf = real


def phase_vamana_ivfknn(smi: str, pts, q, gt) -> dict:
    """Cell vamana-1M-ivfknn: `build_vamana_knn(degree_bound=48,
    knn_backend="ivf")`, the call "auto" makes above 2M points (cap factor
    3.0), with the counts set to 0 just before and read just after: B1 and
    B4 must not launch (the backend switched). The kNN tables' recall
    against exact neighbours on 1000 sampled rows, then exact traversal at
    L = 16 / E = 8, gated at 0.985."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.benchmark import ground_truth, recall_at_k, sweep_exact
    from diskrag_tpu_torch.graph.knn_build import build_vamana_knn

    stages: dict = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with _captured_knn_tables() as tables:
        index = build_vamana_knn(pts, degree_bound=48, alpha=1.2, seed=0, knn_backend="ivf",
                                 device="cuda", stage_seconds=stages)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = read_counts()
    require(launches["B1"] == 0 and launches["B4"] == 0,
            f"the ivf-backend build launched the flat scan's kernels: {launches}")
    n = index.adjacency.shape[0]
    adj = index.adjacency
    require(adj.shape == (n, 48) and int(adj.max()) < n and int(adj.min()) >= -1, "adjacency out of range")
    require(not bool((adj == torch.arange(n, device=adj.device)[:, None]).any()), "self edges")
    knn_k = tables["ids"].shape[1]
    sample = np.random.default_rng(0).choice(n, size=1000, replace=False)
    exact = ground_truth(pts, pts[sample], knn_k + 1, device="cuda")
    exact_wo_self = np.array([row[row != s][:knn_k] for row, s in zip(exact, sample)])
    table_recall = recall_at_k(tables["ids"][sample], exact_wo_self, knn_k)
    table_recall_10 = recall_at_k(tables["ids"][sample], exact_wo_self, 10)
    points = sweep_exact(index, q, gt, k=MAIN_K, widths=(16,), expand_widths=(8,), min_seconds=0.5)
    rec = points[0].recall
    require(rec >= 0.985, f"ivf-backend graph exact recall@10 L=16/E=8 {rec} < 0.985")
    emit({"phase": "main-graph-ivfknn", "cell": "vamana-1M-ivfknn", "n": n, "d": pts.shape[1],
          "degree_bound": 48, "knn_k": knn_k, "build_seconds": build_s, "stage_seconds": stages,
          "launches": launches, "peak_device_gb": build_peak_bytes(stages) / 2**30,
          "peak_device_bytes_by_stage": stages.pop("peak_device_bytes"),
          "knn_table_recall_at_knn_k": table_recall, "knn_table_recall_at_10": table_recall_10,
          "table_sample_rows": 1000, "exact_L16_E8": {"recall_at_10": rec, "qps": points[0].qps,
                                                      "rounds_per_pass": points[0].rounds},
          "recall_gate": 0.985, "flat_backend_graph_pr3": 0.9950, "card": smi})
    del index, tables
    torch.cuda.empty_cache()
    return {"knn_seconds": stages["knn"]}


def phase_ivfknn_resume(smi: str, pts) -> None:
    """Cell vamana-200k-ivfknn-resume: two ivf-backend builds with one
    `checkpoint_dir`; the second loads the saved "knn" phase: its kNN stage
    takes under a tenth of the first's, and its adjacency is the first's
    bit for bit."""
    import torch

    from diskrag_tpu_torch.graph.knn_build import build_vamana_knn

    ckpt = ROOT / "build" / "chip_smoke" / "ivfknn_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    runs = []
    try:
        for _ in range(2):
            stages: dict = {}
            t0 = time.perf_counter()
            index = build_vamana_knn(pts, degree_bound=48, alpha=1.2, seed=0, knn_backend="ivf",
                                     device="cuda", stage_seconds=stages, checkpoint_dir=str(ckpt))
            torch.cuda.synchronize()
            runs.append((index.adjacency, stages, time.perf_counter() - t0))
            del index
        files = sorted(p.name for p in ckpt.iterdir())
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    (adj1, st1, s1), (adj2, st2, s2) = runs
    require(files == ["knn.npz", "tag.json"], f"checkpoint files {files}")
    require(st2["knn"] < 0.1 * st1["knn"], f"resumed kNN stage {st2['knn']} s >= a tenth of {st1['knn']} s")
    require(bool(torch.equal(adj1, adj2)), "the resumed build's adjacency differs")
    emit({"phase": "main-graph-ivfknn", "cell": "vamana-200k-ivfknn-resume", "n": len(pts),
          "first": {"build_seconds": s1, "stage_seconds": st1},
          "resumed": {"build_seconds": s2, "stage_seconds": st2},
          "adjacency": "bit-identical", "checkpoint_files": files, "card": smi})
    del runs, adj1, adj2
    torch.cuda.empty_cache()


# recall@10 gates of the streaming cell (the JAX package's v5e figures less
# 0.01: 0.9967-0.9969 mid-stream and 0.9982 at the end at a 200k base,
# `benchmarks/last_streaming_tpu.json`; 0.9985 at the end at 1M,
# `benchmarks/last_streaming_1m_tpu.json`)
STREAM_MID_GATE, STREAM_FINAL_GATE = 0.9867, {200_000: 0.9882, 1_000_000: 0.9885}
STREAM_SUBWAVES = 8  # a 32,768-row buffer in 4096-row sub-waves: one B1 and one B4 each


def merge_shape_kernels(idx, smi: str) -> dict:
    """B1 and B4 on the exact operands of one sub-wave of the kNN merge
    (`index.streaming.merge_scan_table` over the padded table, the last
    4096 placed rows as queries, quantized and handed over as
    `flat_search_fused` hands them: NB = 4096, kk = 4 * 65 = 260), under L2
    (capacity pads at 1e15: norms ~1.3e32, finite) and under cosine (pads'
    codes and scales zeroed). Both bit-identical to their plain versions;
    timed and bounded (all table rows: the scan reads the pads too)."""
    import torch

    from diskrag_tpu_torch.index.streaming import merge_scan_table
    from diskrag_tpu_torch.ops import flat_scan as fs

    vectors, n_used = idx.index.vectors, idx.n_graph
    rows, d = vectors.shape
    b, nb, kk = 4096, 4096, 260
    q = vectors[n_used - b : n_used]
    out = {}
    for metric in ("l2", "cosine"):
        codes, scales, norms = merge_scan_table(vectors, n_used, metric)
        require(bool(torch.isfinite(norms).all()), f"{metric}: non-finite norms in the merge table")
        qf = q / (torch.sqrt(torch.sum(q * q, -1, keepdim=True)) + 1e-12) if metric == "cosine" else q
        qc, qs = fs.quantize_int8(qf)
        args = (qc, codes, norms)
        kw = dict(n_buckets=nb, use_norms=metric == "l2", q_scales=qs, db_scales=scales)
        vals, row = compare_b1(*args, **kw)
        require(not bool(torch.isnan(vals).any()), f"{metric}: NaN in B1's scores")
        lk, lr = fs.topk_lanes(vals, kk), fs.topk_lanes_ref(vals, kk)
        torch.cuda.synchronize()
        require(bool(torch.equal(lk, lr)), f"B4 differs at the merge shape ({metric})")
        entry = {"B1": {"b": b, "rows": rows, "n_used": n_used, "nb": nb, "match": row["match"],
                        "max_abs_err": row["max_abs_err"]},
                 "B4": {"b": b, "nb": nb, "kk": kk, "match": "bit-identical",
                        "max_abs_err": float((lk - lr).abs().max())}}
        if metric == "l2":  # timed once: the cosine call is the same work
            ops = fs._scan_operands(*args, n_valid=None, **kw)
            call = lambda: fs.scan_bucketed_topk(*args, **kw)  # noqa: E731
            b1_bound, b1_by = b1_bound_ms(b, rows, d, nb)
            b4_bound, b4_by = b4_bound_ms(b, nb, kk)
            entry["B1"].update(ms=cuda_ms(call, 10), device_ms=kernel_device_ms(call, 5),
                               plain_ms=cuda_ms(lambda: fs.scan_bucketed_topk_ref(*ops), 1),
                               library_ms=None, bound_ms=b1_bound, bound_by=b1_by)
            entry["B4"].update(**b4_timed(vals, kk), bound_ms=b4_bound, bound_by=b4_by)
        out[metric] = entry
    emit({"phase": "kernels", "case": "streaming kNN merge sub-wave (NB 4096, kk 260)",
          "card": smi, **out})
    return {name: {**out["l2"][name], "cosine": out["cosine"][name]} for name in ("B1", "B4")}


def _live_recall(idx, queries, live_ext, live_vecs):
    """recall@10 of the tier's merged search (L = 32) against the exact
    answer over the live vectors, in external ids; and the served ids."""
    from diskrag_tpu_torch.benchmark import ground_truth, recall_at_k

    gt = live_ext[ground_truth(live_vecs, queries, MAIN_K, device="cuda")]
    ids, _ = idx.search(queries, k=MAIN_K, search_width=32)
    ids = ids.cpu().numpy()
    return recall_at_k(ids, gt, MAIN_K), ids


def _reference_consolidate(idx, queries, live_ext, live_vecs) -> dict:
    """The JAX package's consolidate policy on the tier's present state,
    measured beside the port's: `graph.dynamic.consolidate` refining a
    random tenth of the rows (`diskrag_tpu/index/streaming.py:777-780`),
    then exact traversal at L = 32 from the result's entry points. Leaves
    the tier as it was. Returns seconds, launches, recall@10 and the ids
    served (external)."""
    import torch

    from diskrag_tpu_torch.benchmark import ground_truth, recall_at_k
    from diskrag_tpu_torch.graph import dynamic
    from diskrag_tpu_torch.graph.search import beam_search
    from diskrag_tpu_torch.graph.types import VamanaIndex

    n0 = idx.n_graph
    used = VamanaIndex(vectors=idx.index.vectors[:n0], adjacency=idx.index.adjacency[:n0],
                       medoid=idx.index.medoid, metric=idx.metric,
                       entry_points=idx.index.entry_points)
    reset_counts()
    t = time.perf_counter()
    new, old_to_new = dynamic.consolidate(used, idx._graph_deleted[:n0],
                                          build_width=idx.build_width, alpha=idx.alpha,
                                          refine_fraction=0.1, seed=idx.seed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = read_counts()
    res = beam_search(new.vectors, new.adjacency, new.medoid, queries, search_width=32,
                      k=MAIN_K, expand_width=8, metric=new.metric, entry_points=new.entry_points)
    ids = idx._graph_ext[:n0].cpu().numpy()[old_to_new >= 0][res.ids.cpu().numpy()]
    gt = live_ext[ground_truth(live_vecs, queries, MAIN_K, device="cuda")]
    return {"refine_fraction": 0.1, "seconds": seconds, "launches": launches,
            "recall_at_10": recall_at_k(ids, gt, MAIN_K), "ids": ids}


def phase_main_streaming(smi: str, base_n: int = 200_000, stream_n: int = 131_072) -> dict:
    """The streaming tier at the JAX bench's protocol
    (`diskrag_tpu_torch.tools.streaming_bench`, in process): a degree-48
    base of `base_n` points, 131,072 more streamed in batches of 1024
    through `StreamingIndex` with its defaults (buffer 32,768, kNN merge,
    fraction 0.25; the run's ingest reserved, as the JAX bench does).
    Gates: recall@10 at both mid-stream probes and at the end; four merges;
    exactly 8 launches each of B1 and B4 per merge and no other kernel.
    Then, once each on the same tier: B1 / B4 held at the merge's shape, a
    profiled merged-search batch, a rebuild-path merge (B1 and B4 through
    `build_vamana_knn`), a `merge_method="wave"` merge (G1 once a wave), and a
    delete of 10% of the live ids followed by `consolidate` (no tombstoned
    id served, recall no more than 0.01 under the pre-delete figure), with
    the JAX package's consolidate policy measured beside it on the same
    state (its recall printed, not gated)."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.benchmark import make_dataset
    from diskrag_tpu_torch.index import streaming as streaming_mod
    from diskrag_tpu_torch.tools import streaming_bench

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with _calls(streaming_mod, "beam_search") as searches:
        res, idx, queries = streaming_bench.run(base_n=base_n, stream_n=stream_n, batch=1024,
                                                dim=MAIN_D, n_queries=MAIN_B, seed=42,
                                                device="cuda")
    launches = read_counts()
    phase_s = time.perf_counter() - t0
    n_merges = res["n_merges"]
    per_merge = [m["launches"] for m in res["merges"]]
    built = res["base_build_launches"]
    mids = [p["recall"] for p in res["mid_stream_probes"]]
    final_gate = STREAM_FINAL_GATE[base_n]
    emit({"phase": "main-streaming", "base_n": base_n, "stream_n": stream_n, "d": MAIN_D,
          **{k: v for k, v in res.items() if k not in ("merges", "base_n", "stream_n")},
          "merge_seconds": [m["seconds"] for m in res["merges"]],
          "merge_stage_seconds": [m["stage_seconds"] for m in res["merges"]],
          "launches_per_merge": per_merge, "launches": launches,
          "recall_gates": {"mid": STREAM_MID_GATE, "final": final_gate},
          "jax_v5e_recall": ("0.9967-0.9969 mid, 0.9982 final" if base_n == 200_000
                             else "0.9973-0.9978 mid, 0.9985 final"),
          "graph_rows_padded": idx._graph_capacity,
          "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
          "phase_seconds": phase_s, "card": smi})
    require(n_merges == 4, f"{n_merges} merges, expected 4")
    require(all(m["B1"] == m["B4"] == STREAM_SUBWAVES
                and not any(v for k, v in m.items() if k not in ("B1", "B4")) for m in per_merge),
            f"a kNN merge did not launch B1 and B4 {STREAM_SUBWAVES} times each: {per_merge}")
    # G1 serves the stream's graph searches (the probes), once a search
    require(all(launches[k] == built[k] + (STREAM_SUBWAVES * n_merges if k in ("B1", "B4") else 0)
                for k in launches if k not in ("G1", "G2")),
            f"the stream launched {launches}: its base build {built}, its merges {per_merge}")
    require(launches["G1"] == built["G1"] + searches["n"] and searches["n"] > 0
            and launches["G2"] - built["G2"] == launches["G1"] - built["G1"],
            f"G1 launched {launches['G1']} times in the stream, its graph searches {searches['n']}")
    require(len(mids) == 2 and min(mids) >= STREAM_MID_GATE,
            f"mid-stream recall {mids} < {STREAM_MID_GATE}")
    require(res["final_recall"] >= final_gate, f"final recall {res['final_recall']} < {final_gate}")
    q_dev = torch.as_tensor(queries, device="cuda")
    emit(profile_calls(lambda: idx.search(q_dev, k=MAIN_K, search_width=32), 3,
                       f"streaming-{base_n // 1000}k merged search (L = 32, buffer half full)",
                       watch=("gemm", "sort", "index")))
    if base_n != 200_000:
        return {}
    kernels = merge_shape_kernels(idx, smi)

    pts, _ = make_dataset(base_n + stream_n, MAIN_D, MAIN_B, seed=42)
    # the QPS measurement left duplicates of the first half-buffer of the
    # stream in the buffer (ids are dense: they follow the stream's):
    # tombstone them, so every live vector is distinct
    idx.delete(base_n + stream_n + np.arange(idx.n_buffered))
    live_ext = np.arange(len(pts))
    out = {}

    # rebuild path: the whole live set through build_vamana_knn
    idx.merge_insert_max_fraction = 0.0
    reset_counts()
    t = time.perf_counter()
    idx.merge()
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t
    rebuild_launches = read_counts()
    rec, _ = _live_recall(idx, q_dev, live_ext, pts)
    checks = [(rebuild_launches["B1"] == rebuild_launches["B4"] > 0,
               f"the rebuild-path merge did not go through B1 and B4: {rebuild_launches}"),
              (idx.rows_compacted and idx.n_graph == len(pts), "the rebuild kept tombstoned rows")]
    out["rebuild"] = {"seconds": rebuild_s, "launches": rebuild_launches, "recall_at_10": rec}

    # wave path: the last 4096 stream points re-inserted under new ids (the
    # old rows tombstoned), merged by wave_step: G1 once a wave (its beam search)
    idx.merge_insert_max_fraction, idx.merge_method = 0.25, "wave"
    moved = live_ext[-4096:]
    idx.delete(moved)
    new_ext = idx.insert(pts[moved])
    live_ext = np.concatenate([live_ext[:-4096], new_ext])
    reset_counts()
    t = time.perf_counter()
    with _calls(streaming_mod, "wave_step") as waves:
        idx.merge()
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t
    wave_launches = read_counts()
    rec_wave, _ = _live_recall(idx, q_dev, live_ext, pts)
    checks.append((wave_launches == {**{k: 0 for k in wave_launches},
                                     **searches_on_the_card(waves["n"])}
                   and waves["n"] > 0,
                   f"the wave merge launched {wave_launches}, expected G2 and G1 once a wave "
                   f"({waves['n']})"))
    out["wave"] = {"seconds": wave_s, "rows": 4096, "launches": wave_launches,
                   "recall_at_10": rec_wave}

    # delete 10% of the live ids, then consolidate
    rng = np.random.default_rng(0)
    gone = rng.choice(len(live_ext), size=len(live_ext) // 10, replace=False)
    idx.delete(live_ext[gone])
    keep = np.ones(len(live_ext), bool)
    keep[gone] = False
    _, ids = _live_recall(idx, q_dev, live_ext[keep], pts[keep])
    checks.append((not np.isin(ids, live_ext[gone]).any(),
                   "a tombstoned id was served before consolidate"))
    ref = _reference_consolidate(idx, q_dev, live_ext[keep], pts[keep])
    checks.append((not np.isin(ref.pop("ids"), live_ext[gone]).any(),
                   "the reference consolidate served a tombstoned id"))
    reset_counts()
    t = time.perf_counter()
    idx.consolidate()
    torch.cuda.synchronize()
    cons_s = time.perf_counter() - t
    cons_launches = read_counts()
    rec_del, ids = _live_recall(idx, q_dev, live_ext[keep], pts[keep])
    checks += [(not np.isin(ids, live_ext[gone]).any(), "a tombstoned id was served after consolidate"),
               (rec_del >= rec_wave - 0.01,
                f"recall after delete + consolidate {rec_del} < {rec_wave} - 0.01")]
    out["delete_consolidate"] = {"deleted": len(gone), "consolidate_seconds": cons_s,
                                 "launches": cons_launches, "recall_at_10": rec_del,
                                 "recall_before_delete": rec_wave, "n_graph": idx.n_graph,
                                 "jax_policy": ref}
    emit({"phase": "main-streaming-paths", **out, "card": smi})
    for cond, what in checks:
        require(cond, what)
    del idx, q_dev
    torch.cuda.empty_cache()
    merge_launches = {k: launches[k] - built[k] for k in launches}
    return {"kernels": kernels, "launches": merge_launches, "n_merges": n_merges,
            "g1_searches": searches["n"], "g1_wave_merge": wave_launches["G1"]}


WAVE_RECALL_GATE = 0.972  # the JAX wave graph's 0.982 at L = 48 (docs/PERFORMANCE.md:340-342) less 0.01


def phase_main_wave(smi: str, base, pts, q, gt) -> int:
    """The wave-insertion build through the entry point a user calls:
    `build_index_from_vectors(index_type="vamana", build_method="wave")`
    with every other default, served by `SearchEngine` with exact
    traversal at L = 48 (recall@10 gate). The build launches G1 once a
    wave (`wave_step`'s one beam search; the prune, the PQ fit and encode
    run no kernel) and nothing else; the search G1 once. Returns the
    build's G1 launches."""
    import torch

    from diskrag_tpu_torch.benchmark import recall_at_k
    from diskrag_tpu_torch.build_index import build_index_from_vectors
    from diskrag_tpu_torch.engine import SearchEngine
    from diskrag_tpu_torch.graph import build as build_mod

    name = f"wave_{len(pts) // 1000}k"
    index_dir = make_collection(base, name, pts)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with _calls(build_mod, "wave_step") as waves:
        meta = build_index_from_vectors(pts, index_dir, index_type="vamana", build_method="wave",
                                        device="cuda")
    build_s = time.perf_counter() - t0
    build_launches = read_counts()
    engine = SearchEngine(name, base_dir=str(base), device="cuda")
    reset_counts()
    t = time.perf_counter()
    _, ids, stats = engine.search_batch(q, k=MAIN_K, l_search=48, use_pq_search=False)
    batch_s = time.perf_counter() - t
    launches = read_counts()
    recall = recall_at_k(ids, gt, MAIN_K)
    emit({"phase": "main-wave", "n": len(pts), "d": pts.shape[1], "R": meta["R"],
          "L_build": meta["L"], "alpha": meta["alpha"], "use_pq": meta["use_pq"],
          "build_seconds_graph": meta["build_seconds"], "build_seconds_total": build_s,
          "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
          "l_search": 48, "recall_at_10": recall, "recall_gate": WAVE_RECALL_GATE,
          "rounds": stats["rounds"], "ms_per_batch": batch_s * 1e3,
          "waves": waves["n"], "launches_build": build_launches, "launches_search": launches,
          "card": smi})
    require(meta["build_method"] == "wave", f"built {meta.get('build_method')}")
    require(build_launches == {**{k: 0 for k in build_launches},
                               **searches_on_the_card(waves["n"])}
            and waves["n"] > 0,
            f"the wave build launched {build_launches}, expected G2 and G1 once a wave "
            f"({waves['n']})")
    require(stats["search_type"] == "exact", f"served as {stats['search_type']}")
    require(launches == {**{k: 0 for k in launches}, **searches_on_the_card(1)},
            f"exact traversal launched {launches}, expected G2 and G1 once")
    require(recall >= WAVE_RECALL_GATE, f"wave graph recall@10 {recall} < {WAVE_RECALL_GATE} at L=48")
    del engine
    torch.cuda.empty_cache()
    return build_launches["G1"]


def phase_api_streaming(smi: str, base, name: str, n_rows: int, q) -> int:
    """The default 200k vamana collection (with the metadata `phase_api`
    gave it) behind `create_app` with `serving_mode="streaming"` and the
    mock embedder, on a socket on 127.0.0.1: `/insert` of a few texts
    answers 200 with the collection's new row ids, `/search` for an
    inserted text returns its id at rank 1, `/delete` answers 200 and the
    deleted id is never served again. Then a fresh streaming engine adopts
    the inserted rows and takes four more through `insert_texts`,
    `flush_index` persists them, and a fresh engine in mode "auto" holds
    them all and finds the four by search. The streaming engine behind the
    server also takes the pipelined row (the cell's queries, l_search 64)
    after the requests. The requests launch G1 once a graph search within
    its limits (the collection's tuned L is past them) and nothing else;
    their G1 launches are returned. Runs last: it grows the collection."""
    import asyncio

    import aiohttp
    import numpy as np
    import torch
    from aiohttp import web

    from diskrag_tpu_torch.api import AppState, create_app
    from diskrag_tpu_torch.data import EmbeddingConfig, EmbeddingGenerator
    from diskrag_tpu_torch.engine import SearchEngine
    from diskrag_tpu_torch.index import streaming as streaming_mod
    from diskrag_tpu_torch.ops import traverse

    cfg = EmbeddingConfig(provider="mock", model="mock", dimension=MAIN_D)
    state = AppState(base_dir=str(base), embedding_config=cfg, serving_mode="streaming",
                     device="cuda")
    state.embedder = EmbeddingGenerator(cfg, cache_dir=base / ".embeddings")
    state.prepare()
    state.get_engine(name)  # bring-up before the counted requests
    texts = [f"streamed document {i}" for i in range(4)]
    sent: list = []

    async def exchange() -> None:
        runner = web.AppRunner(create_app(state))
        await runner.setup()
        try:
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            url = f"http://127.0.0.1:{runner.addresses[0][1]}"

            async def post(path, payload):
                t = time.perf_counter()
                async with aiohttp.request("POST", url + path, json=payload) as resp:
                    out = (path, resp.status, await resp.json(), (time.perf_counter() - t) * 1e3)
                sent.append(out)
                return out[1], out[2]

            status, ins = await post("/insert", {"collection": name, "texts": texts})
            require(status == 200 and ins["ids"] == list(range(n_rows, n_rows + 4)),
                    f"/insert answered {status}: {ins}")
            for text in texts:
                status, out = await post("/search", {"collection": name, "query": text, "top_k": 5})
                require(status == 200 and out["results"][0]["text"] == text,
                        f"/search for an inserted text: {status} {out['results'][:1]}")
                require(out["stats"]["search_type"] == "streaming", f"served as {out['stats']}")
            status, d = await post("/delete", {"collection": name, "ids": [ins["ids"][1]]})
            require(status == 200 and d["deleted"] == 1, f"/delete answered {status}: {d}")
            for text in texts:
                status, out = await post("/search", {"collection": name, "query": text, "top_k": 5})
                require(status == 200 and all(r["text"] != texts[1] for r in out["results"]),
                        "a deleted row was served")
        finally:
            await runner.cleanup()

    reset_counts()
    with _calls(streaming_mod, "beam_search") as searches:
        asyncio.run(exchange())
    launches = read_counts()
    # one graph search a /search, on G1 where its width is within G1's reach
    # (the collection's tuned L, 570 by default, is not: the plain rounds)
    widths = [out["stats"]["L_search"] for path, _, out, _ in sent if path == "/search"]
    g1 = sum(w <= traverse.MAX_WIDTH for w in widths)
    require(searches["n"] == len(widths) > 0
            and launches == {**{k: 0 for k in launches}, **searches_on_the_card(g1)},
            f"the streaming requests launched {launches} in {searches['n']} graph searches, "
            f"expected G1 once a search at L <= {traverse.MAX_WIDTH} (L {widths})")
    pipelined_row(smi, state.get_engine(name), q, "api-streaming-200k (streaming engine)",
                  expect={"G1": "batches", "G2": "batches"}, l_search=64)
    del state
    # deletions are session-local: a fresh streaming engine adopts the four
    # inserted rows past the index watermark; four more rows near existing
    # points (the mock embeddings are unit vectors, ~45 away from every
    # data point: a graph search cannot reach them once merged, as in the
    # JAX package) go in through `insert_texts`, then `flush_index`
    engine = SearchEngine(name, base_dir=str(base), serving_mode="streaming", device="cuda",
                          run_diagnostics=False)
    require(engine.streaming.n_buffered == 4, f"adopted {engine.streaming.n_buffered} rows")
    rng = np.random.default_rng(1)
    near = np.load(engine.manager.get_vectors_path(name), mmap_mode="r")[:4]
    near = (near + 0.3 * rng.standard_normal(near.shape)).astype(np.float32)
    got = engine.insert_texts([f"near document {i}" for i in range(4)], vectors=near)
    require(got.tolist() == list(range(n_rows + 4, n_rows + 8)), f"insert_texts gave {got}")
    reset_counts()
    t = time.perf_counter()
    flushed = engine.flush_index()
    flush_s = time.perf_counter() - t
    flush_launches = read_counts()
    del engine
    auto = SearchEngine(name, base_dir=str(base), device="cuda", run_diagnostics=False)
    embed = EmbeddingGenerator(cfg, cache_dir=base / ".embeddings").generate
    mock_vecs = np.stack([embed(t) for t in texts]).astype(np.float32)
    held = auto.index.vectors[n_rows : n_rows + 4].cpu().numpy()
    _, ids, stats = auto.search_batch(near, k=1, l_search=64)
    texts_back = [r[0]["text"] for r in auto.search_many(
        [f"near document {i}" for i in range(4)], k=1,
        embedding_fn=dict(zip([f"near document {i}" for i in range(4)], near)).__getitem__,
        l_search=64)["results"]]
    require(flushed["n_points"] == n_rows + 8 and np.array_equal(held, mock_vecs)
            and ids[:, 0].tolist() == list(range(n_rows + 4, n_rows + 8))
            and texts_back == [f"near document {i}" for i in range(4)],
            f"the flushed index serves {ids[:, 0].tolist()} {texts_back} ({flushed})")
    emit({"phase": "api-streaming", "collection": name, "n": n_rows,
          "requests": [{"path": p, "status": st, "ms": ms} for p, st, _, ms in sent],
          "launches_requests": launches, "flush": flushed, "flush_seconds": flush_s,
          "launches_flush": flush_launches, "auto_search_type": stats["search_type"],
          "card": smi})
    del auto
    torch.cuda.empty_cache()
    return launches["G1"]


# recall@10 gates of sharded-1M-4x250k at l_search 64: exact traversal per
# shard (mode "auto"), and the host tier over the build's own default PQ,
# m = 4 at 1M, whose floor is what the defaults reach (0.7417 on an H100
# 80GB HBM3 at 700 W, where one graph of all 1M points over the same
# quantizer reads 0.462: the quantizer limits it, not the shard merge)
# less 0.01
SHARDED_AUTO_GATE = 0.95
SHARDED_PQ_DEFAULT_GATE = 0.7317
SHARDED_SHARDS = 4
SHARDED_SEARCH_TYPE = {"auto": "sharded", "sharded_flat": "sharded_flat",
                       "host_tier": "sharded_host_tier"}


def _placed_bytes(*placed) -> int:
    """Device bytes of some `PlacedShards` (one copy per shard and device)."""
    return sum(sum(p.nbytes_by_device().values()) for p in placed if p is not None)


def _sharded_drive(engine, q, gt, l_search: int | None, reps: int = 5) -> dict:
    """One warm-up `search_batch`, then `drive`: recall@10, ms a batch
    (median of `reps`), rounds, launches; ids and distances checked."""
    import numpy as np

    from diskrag_tpu_torch.benchmark import recall_at_k

    engine.search_batch(q, k=MAIN_K, l_search=l_search)
    dists, ids, all_stats, batch_s, launches = drive(engine, q, reps, l_search=l_search)
    require(ids.shape == (len(q), MAIN_K) and bool(np.isfinite(dists).all())
            and bool((np.diff(dists, axis=1) >= 0).all()), "sharded distances not finite and ascending")
    med = float(np.median(batch_s))
    return {"l_search": all_stats[-1]["L_search"], "recall_at_10": recall_at_k(ids, gt, MAIN_K),
            "ms_per_batch_median": med * 1e3, "ms_per_batch": [s * 1e3 for s in batch_s],
            "qps": len(q) / med, "rounds_per_batch": sum(s.get("rounds", 0) for s in all_stats) / reps,
            "rounds": sum(s.get("rounds", 0) for s in all_stats),
            "search_type": all_stats[-1]["search_type"], "launches": launches,
            "stage_ms": all_stats[-1].get("stage_ms"), "_ids": ids}


def _sharded_http(base, name: str, mode: str, engine, mesh_devices: list) -> dict:
    """One HTTP /search through `create_app` on 127.0.0.1, answered by
    `engine` (already serving `name` in `mode`): its status, ms, rounds and
    launches. B5 must launch once a round in the host tier, no kernel
    otherwise."""
    import asyncio

    import aiohttp
    from aiohttp import web

    from diskrag_tpu_torch.api import AppState, create_app
    from diskrag_tpu_torch.data import EmbeddingConfig, EmbeddingGenerator
    from diskrag_tpu_torch.ops import traverse

    cfg = EmbeddingConfig(provider="mock", model="mock", dimension=MAIN_D)
    state = AppState(base_dir=str(base), embedding_config=cfg, serving_mode=mode,
                     device="cuda", mesh_devices=mesh_devices)
    state.embedder = EmbeddingGenerator(cfg, cache_dir=base / ".embeddings")
    state.engines[name] = engine
    sent: list = []

    async def exchange() -> None:
        runner = web.AppRunner(create_app(state))
        await runner.setup()
        try:
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            url = f"http://127.0.0.1:{runner.addresses[0][1]}/search"
            t = time.perf_counter()
            async with aiohttp.request("POST", url, json={
                    "collection": name, "query": "how do I use feature 3?", "top_k": 5}) as resp:
                sent.append((resp.status, await resp.json(), (time.perf_counter() - t) * 1e3))
        finally:
            await runner.cleanup()

    reset_counts()
    asyncio.run(exchange())
    launches = read_counts()
    status, body, ms = sent[0]
    require(status == 200 and len(body["results"]) == 5, f"/search under {mode} answered {status}")
    st = body["stats"]
    kind = SHARDED_SEARCH_TYPE[mode]
    b5 = st.get("rounds", 0) if mode == "host_tier" else 0
    # one exact search a mesh slot, on G1 where its width is within G1's reach
    g1 = len(mesh_devices) if mode == "auto" and st["L_search"] <= traverse.MAX_WIDTH else 0
    others = {k: v for k, v in launches.items() if k not in ("B5", "G1", "G2")}
    require(st["search_type"] == kind and launches["B5"] == b5
            and launches["G1"] == launches["G2"] == g1
            and not any(others.values()),
            f"/search under {mode}: {st['search_type']}, launches {launches}, rounds {b5}")
    return {"serving_mode": mode, "status": status, "ms": ms, "search_type": kind,
            "l_search": st["L_search"], "rounds": st.get("rounds"), "launches": launches}


def phase_main_sharded(smi: str, base, pts, q, gt, *, n_shards: int = SHARDED_SHARDS,
                       full: bool = True) -> dict:
    """Cell sharded-<n>-<S>x<n/S>: `build_index_from_vectors(index_type=
    "sharded", n_shards=S, write_compat=True)` with every other default
    (B1 + B4 in every shard's kNN pass), served through `SearchEngine` on an
    S-slot mesh of one card (`mesh_devices=["cuda:0"] * S`): mode "auto"
    (exact traversal per shard: G1 once a shard and batch) at l_search 64 and at the
    build's recommended L, "sharded_flat" (held against an independent
    top-10 over every row on the card, no kernel) and "host_tier" (the
    default build's residual PQ: B5 by id once a round and shard; bf16
    mode over the same graphs beside it). With `full` (the default run),
    the recall gates and the startup diagnostics, one HTTP /search in each
    mode and the mesh error of a 3-shard index on one card; without it
    (`--sharded-n`), the same graphs traversed by an m = 16 residual PQ
    beside the default one. Every step prints its seconds. Returns the build's B1 / B4 launches and the
    default pq tier's B5 launches and rounds."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.benchmark import recall_at_k
    from diskrag_tpu_torch.build_index import build_index_from_vectors
    from diskrag_tpu_torch.engine import SearchEngine, ServingConfigError
    from diskrag_tpu_torch.parallel import ShardedHostTier, load_sharded_index
    from diskrag_tpu_torch.pq.residual import ResidualPQ

    t_phase = time.perf_counter()
    n, s = len(pts), n_shards
    per = -(-n // s)
    mesh_devices = ["cuda:0"] * s

    def size(m: int) -> str:
        return f"{m // 1_000_000}M" if m % 1_000_000 == 0 else f"{m // 1000}k"

    cell = f"sharded-{size(n)}-{s}x{size(per)}"
    name = f"sharded_{n}"
    index_dir = make_collection(base, name, pts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    meta = build_index_from_vectors(pts, index_dir, index_type="sharded", n_shards=s,
                                    write_compat=True, device="cuda")
    build_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = build_peak_bytes(*(b["stage_seconds"] for b in meta["build_shards"])) / 1e9
    expect = -(-per // 4096)  # one B1 + one B4 per 4096-row block of a shard's kNN pass
    shards = [{"shard": b["shard"], "rows": b["rows"], "seconds": b["seconds"],
               "stage_seconds": b["stage_seconds"],
               "launches": {k: v for k, v in b["launches"].items() if v}}
              for b in meta["build_shards"]]
    others = {k: v for k, v in launches.items() if k not in ("B1", "B4")}
    require(all(b["launches"].get("B1") == b["launches"].get("B4") == expect for b in shards)
            and launches["B1"] == launches["B4"] == expect * s and not any(others.values()),
            f"the sharded build launched {launches} ({[b['launches'] for b in shards]}); "
            f"expected {expect} B1 + B4 a shard")
    if full:
        write_metadata(base, name, n)
    emit({"phase": "main-sharded", "cell": cell, "step": "build", "n": n, "d": pts.shape[1],
          "n_shards": s, "rows_per_shard": per, "R": meta["R"], "L_build": meta["L"],
          "pq_kind": meta.get("pq_kind"), "n_subvectors": meta.get("n_subvectors"),
          "pq_n_coarse": meta.get("pq_n_coarse"),
          "recommended_search_L": meta["recommended_search_L"], "build_seconds": build_s,
          "build_stage_seconds": meta["build_stage_seconds"], "shards": shards,
          "launches": launches, "launches_per_shard_expected": expect,
          "peak_device_gb": peak_gb, "host_f32_bytes": int(pts.nbytes),
          "seconds": time.perf_counter() - t_phase, "card": smi})
    out: dict = {"build_launches": {"B1": launches["B1"], "B4": launches["B4"]}}
    http: list = []

    # mode "auto": exact traversal per shard, merged
    t_step = t0 = time.perf_counter()
    engine = SearchEngine(name, base_dir=str(base), device="cuda", mesh_devices=mesh_devices)
    load_s = time.perf_counter() - t0
    require(engine.sharded is not None and engine.mesh.shape == {"data": 1, "shard": s},
            f"mode auto did not serve the sharded index: {engine.mesh}")
    diagnostic = bool(engine.diagnostics and engine.diagnostics["passed"])
    require(diagnostic or not full, f"startup diagnostic failed: {engine.diagnostics}")
    at64 = _sharded_drive(engine, q, gt, 64)
    at64.pop("_ids")
    require(at64["launches"] == {**{k: 0 for k in at64["launches"]},
                                 **searches_on_the_card(5 * s)},
            f"exact sharded traversal launched {at64['launches']}, expected G1 once a shard "
            f"and batch")
    require(at64["search_type"] == "sharded", f"served as {at64['search_type']}")
    require(at64["recall_at_10"] >= SHARDED_AUTO_GATE or not full,
            f"sharded auto recall@10 {at64['recall_at_10']} < {SHARDED_AUTO_GATE} at l_search=64")
    t = time.perf_counter()
    _, ids_def, st_def = engine.search_batch(q, k=MAIN_K)
    default_ms = (time.perf_counter() - t) * 1e3
    sh = engine.sharded
    prof = with_launches_per_round(profile_batch(engine, q, steps=1, path=f"{cell}-auto",
                                                 l_search=64, watch=("gather",)),
                                   at64["rounds_per_batch"])
    if full:
        http.append(_sharded_http(base, name, "auto", engine, mesh_devices))
        pipelined_row(smi, engine, q, f"{cell} auto",
                      expect=searches_on_the_card(len(mesh_devices)),
                      l_search=64, n_batches=4,
                      passes=1, profile_batches=0)
    emit({"phase": "main-sharded", "cell": cell, "serving_mode": "auto", "queries": len(q),
          "k": MAIN_K, "load_seconds": load_s, "diagnostic_passed": diagnostic, **at64,
          "recall_gate": SHARDED_AUTO_GATE if full else None,
          "recommended_l": {"l_search": st_def["L_search"], "rounds": st_def["rounds"],
                            "recall_at_10": recall_at_k(ids_def, gt, MAIN_K), "ms": default_ms},
          "device_bytes": _placed_bytes(sh.vectors, sh.adjacency, sh.medoids, sh.global_ids,
                                        sh.entry_points),
          "host_f32_bytes": int(pts.nbytes), "seconds": time.perf_counter() - t_step, "card": smi})
    emit(prof)
    del engine, sh
    torch.cuda.empty_cache()

    # sharded_flat, held against an independent top-10 over every row
    t_step = time.perf_counter()
    engine = SearchEngine(name, base_dir=str(base), serving_mode="sharded_flat", device="cuda",
                          mesh_devices=mesh_devices)
    diagnostic = bool(engine.diagnostics and engine.diagnostics["passed"])
    require(diagnostic or not full, f"startup diagnostic failed: {engine.diagnostics}")
    flat = _sharded_drive(engine, q, gt, None)
    ids = flat.pop("_ids")
    require(not any(flat["launches"].values()), f"sharded_flat launched {flat['launches']}")
    if full:
        http.append(_sharded_http(base, name, "sharded_flat", engine, mesh_devices))
        # the one served path whose device time a batch outlasts the host's
        # embedding, upload and dispatch: the overlap witness is gated here
        pipelined_row(smi, engine, q, f"{cell} sharded_flat", expect={}, n_batches=4,
                      witness_gate=True, profile_batches=2)
    v16, norms, gids, _ = engine.sharded_flat
    flat_bytes = _placed_bytes(v16, norms, gids)
    del engine, v16, norms, gids
    torch.cuda.empty_cache()
    db = torch.as_tensor(pts, device="cuda")
    vn = torch.sum(db * db, dim=1)
    db = db.to(torch.bfloat16).to(torch.float32)
    q_d = torch.as_tensor(q, device="cuda")
    ref = torch.matmul(q_d.to(torch.bfloat16).to(torch.float32), db.T)
    del db
    ref.mul_(-2.0).add_(vn[None, :]).add_(torch.sum(q_d * q_d, dim=1, keepdim=True))
    ref_d, ref_i = torch.topk(ref, MAIN_K, dim=1, largest=False)
    got_d = torch.gather(ref, 1, torch.as_tensor(ids, device="cuda").long())
    del ref
    gap = (torch.sort(got_d, dim=1).values - ref_d).abs()
    tol = 1e-5 * ref_d[:, -1:].abs()
    mismatched = int((torch.as_tensor(ids, device="cuda") != ref_i.to(torch.int32)).sum())
    worst = float((gap / ref_d[:, -1:].abs()).max())
    require(bool((gap <= tol).all()),
            f"sharded_flat ids are not a top-10 of every row (largest gap {worst} of the k-th "
            "distance; allowed 1e-5)")
    emit({"phase": "main-sharded", "cell": cell, "serving_mode": "sharded_flat",
          "diagnostic_passed": diagnostic, **flat,
          "reference": "bf16 rows and queries, f32 torch.matmul, torch.topk over all rows",
          "slots_differing_from_reference": mismatched, "largest_gap_of_kth": worst,
          "device_bytes": flat_bytes, "host_f32_bytes": int(pts.nbytes),
          "seconds": time.perf_counter() - t_step, "card": smi})
    del ref_d, ref_i, got_d, gap, q_d, vn
    torch.cuda.empty_cache()

    # host tier: the default build's residual PQ (B5 by id once a round
    # and shard), then bf16 traversal
    t_step = time.perf_counter()
    engine = SearchEngine(name, base_dir=str(base), serving_mode="host_tier", device="cuda",
                          mesh_devices=mesh_devices)
    ht = engine.host_tier
    require(ht.mode == "pq" and isinstance(ht.guide.pq, ResidualPQ) and ht.guide.cells is not None,
            f"the sharded host tier picked {ht.mode} / {type(ht.guide.pq).__name__}")
    diagnostic = bool(engine.diagnostics and engine.diagnostics["passed"])
    require(diagnostic or not full, f"startup diagnostic failed: {engine.diagnostics}")
    pq = _sharded_drive(engine, q, gt, 64)
    pq.pop("_ids")
    others = {k: v for k, v in pq["launches"].items() if k != "B5"}
    require(pq["search_type"] == "sharded_host_tier", f"served as {pq['search_type']}")
    require(pq["launches"]["B5"] == pq["rounds"] > 0 and not any(others.values()),
            f"expected {pq['rounds']} launches of B5 (one a round and shard) and no other: "
            f"{pq['launches']}")
    require(pq["recall_at_10"] >= SHARDED_PQ_DEFAULT_GATE or not full,
            f"sharded host-tier pq recall@10 {pq['recall_at_10']} < {SHARDED_PQ_DEFAULT_GATE} at "
            "l_search=64 (the default PQ)")
    prof = with_launches_per_round(profile_batch(engine, q, steps=1, path=f"{cell}-host-tier-pq",
                                                 l_search=64, watch=("adc_lookup_kernel",)),
                                   pq["rounds_per_batch"])
    if full:
        http.append(_sharded_http(base, name, "host_tier", engine, mesh_devices))
    emit({"phase": "main-sharded", "cell": cell, "serving_mode": "host_tier", "mode": "pq",
          "n_subvectors": ht.guide.pq.n_subvectors, "n_coarse": ht.guide.pq.n_coarse,
          "diagnostic_passed": diagnostic, **pq,
          "recall_gate": SHARDED_PQ_DEFAULT_GATE if full else None,
          "device_bytes": sum(ht.device_bytes().values()),
          "host_f32_bytes": int(pts.nbytes), "seconds": time.perf_counter() - t_step, "card": smi})
    emit(prof)
    out.update(b5_launches=pq["launches"]["B5"], rounds=pq["rounds"])
    reader, mesh = ht.reader, engine.mesh
    del engine, ht
    torch.cuda.empty_cache()

    def tier_row(tier, mode: str, t_step: float) -> dict:
        """The tier's pipelined search as the engine calls it (L = 64,
        E = 4, chunk 500), 5 timed batches after a warm-up, launches
        counted over them."""
        kw = dict(search_width=64, k=MAIN_K, chunk=500, expand_width=4)
        tier.search_pipelined(q, **kw)
        reset_counts()
        times, rounds = [], 0
        for _ in range(5):
            t = time.perf_counter()
            _, ids, st = tier.search_pipelined(q, **kw)
            times.append((time.perf_counter() - t) * 1e3)
            rounds += st["rounds"]
        return {"phase": "main-sharded", "cell": cell, "serving_mode": "host_tier", "mode": mode,
                "l_search": 64, "expand_width": 4, "recall_at_10": recall_at_k(ids, gt, MAIN_K),
                "ms_per_batch_median": float(np.median(times)), "ms_per_batch": times,
                "rounds_per_batch": rounds / 5, "rounds": rounds, "stage_ms": st["stage_ms"],
                "launches": read_counts(), "device_bytes": sum(tier.device_bytes().values()),
                "host_f32_bytes": int(pts.nbytes), "seconds": time.perf_counter() - t_step,
                "card": smi}

    if not full:
        # the same graphs traversed by a residual PQ with m = 16 (the 200k
        # default cell's quantizer): what the default m = 4 costs in recall
        t_step = time.perf_counter()
        rpq16 = ResidualPQ(n_subvectors=16, n_coarse=int(meta["pq_n_coarse"]),
                           device="cuda").fit(pts, seed=0)
        codes16, cells16 = rpq16.encode(pts)
        tier = ShardedHostTier.from_sharded_index(
            load_sharded_index(index_dir / "sharded"), reader, mesh, mode="pq", pq=rpq16,
            codes=codes16, pq_cells=cells16, pq_bias=rpq16.point_bias(codes16, cells16))
        row = tier_row(tier, "pq (m = 16)", t_step)
        others = {k: v for k, v in row["launches"].items() if k != "B5"}
        require(row["launches"]["B5"] == row["rounds"] > 0 and not any(others.values()),
                f"m = 16: expected {row['rounds']} launches of B5 and no other: {row['launches']}")
        emit(row)
        del tier, rpq16, codes16, cells16
        torch.cuda.empty_cache()
    t_step = time.perf_counter()
    tier = ShardedHostTier.from_sharded_index(load_sharded_index(index_dir / "sharded"), reader,
                                              mesh, mode="bf16")
    row = tier_row(tier, "bf16", t_step)
    require(not any(row["launches"].values()), f"the bf16 sharded host tier launched {row['launches']}")
    emit(row)
    del tier
    torch.cuda.empty_cache()

    if full:
        emit({"phase": "main-sharded", "cell": cell, "request": "/search", "requests": http,
              "card": smi})
        # a 3-shard index on the default devices of one card: the JAX
        # engine's configuration error
        t_step = time.perf_counter()
        small = make_collection(base, "sharded_3", pts[:3000])
        build_index_from_vectors(pts[:3000], small, index_type="sharded", n_shards=3,
                                 device="cuda")
        try:
            SearchEngine("sharded_3", base_dir=str(base), device="cuda")
        except ServingConfigError as e:
            require("3 shards" in str(e), f"mesh error without the shard count: {e}")
            emit({"phase": "main-sharded", "cell": "sharded-3000-3x1000", "mesh_error": str(e),
                  "visible_cards": torch.cuda.device_count(),
                  "seconds": time.perf_counter() - t_step, "card": smi})
        else:
            require(torch.cuda.device_count() % 3 == 0,
                    "a 3-shard index was served on a device count it does not divide")
    shutil.rmtree(base / name, ignore_errors=True)
    emit({"phase": "main-sharded", "cell": cell, "step": "total",
          "seconds": time.perf_counter() - t_phase, "card": smi})
    return out


def phase_sharded_multi(smi: str) -> None:
    """`parallel.dryrun.dryrun_multichip(["cuda:0"] * 8)` (the 2 x 4 mesh of
    the JAX dry run), then two processes over gloo on cuda:0, each building
    and searching 2 of 4 shards of `make_dataset(200_000, 128, 1000, seed=0)`
    (`tools.multihost_check`): both processes' merged ids must equal, byte
    for byte, the single-process `sharded_search` over the same shards."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.parallel import make_mesh, sharded_flat_search, sharded_search
    from diskrag_tpu_torch.parallel.dryrun import dryrun_multichip
    from diskrag_tpu_torch.tools.multihost_check import run_local, stack_shards

    reset_counts()
    t0 = time.perf_counter()
    dry = dryrun_multichip(["cuda:0"] * 8)
    emit({"phase": "main-sharded", "step": "dryrun_multichip", "devices": "cuda:0 x 8", **dry,
          "seconds": time.perf_counter() - t0, "launches": read_counts(), "card": smi})

    out_dir = ROOT / "build" / "chip_smoke" / "multihost"
    shutil.rmtree(out_dir, ignore_errors=True)
    n, k, width = 200_000, MAIN_K, 64
    t0 = time.perf_counter()
    res = run_local(out_dir, n=n, dim=MAIN_D, queries=MAIN_B, k=k, search_width=width,
                    processes=2, shards_per_process=2, degree_bound=24, seed=0, device="cuda:0",
                    timeout=600.0)
    two_s = time.perf_counter() - t0
    idx = stack_shards(res)
    mesh = make_mesh(n_shards=4, devices=["cuda:0"] * 4)
    ids, dists = sharded_search(idx, res[0]["queries"], mesh, search_width=width, k=k)
    require(ids.cpu().numpy().tobytes() == res[0]["ids"].astype(np.int32).tobytes()
            == res[1]["ids"].astype(np.int32).tobytes(),
            "the two processes' merged ids differ from the single-process sharded_search")
    v = idx.vectors
    norms = np.einsum("snd,snd->sn", v, v, dtype=np.float32)
    fids, _ = sharded_flat_search(torch.as_tensor(v).to(torch.bfloat16), norms, idx.global_ids,
                                  res[0]["queries"], mesh, k=k)
    require(bool(np.array_equal(fids.cpu().numpy(), res[0]["flat_ids"])),
            "the two processes' flat ids differ from the single-process sharded_flat_search")
    emit({"phase": "main-sharded", "step": "multihost", "processes": 2, "backend": "gloo",
          "device": "cuda:0", "n": n, "shards": 4, "queries": MAIN_B, "search_width": width,
          "seconds_both_processes": two_s,
          "ids": "byte-identical across processes and to the single-process sharded_search",
          "flat_ids": "equal to the single-process sharded_flat_search", "card": smi})
    shutil.rmtree(out_dir, ignore_errors=True)
    del idx
    torch.cuda.empty_cache()


ANGULAR_N = 1_200_000
# recall@10 the JAX package recorded on this configuration
# (`benchmarks/last_angular_tpu.json`; exact L = 48 from
# `docs/PERFORMANCE.md:547`): the gates are these less ANGULAR_SLACK, the
# rpq32 rows less ANGULAR_RPQ32_SLACK (they sit on the ADC ordering's
# collapse on unit vectors, `docs/PERFORMANCE.md:560-567`, where the figure
# follows the codebook's random draw)
ANGULAR_JAX_RECALL = {
    ("exact", 16, 8): 0.9783, ("exact", 32, 8): 0.9913, ("exact", 48, 8): 0.9951,
    ("iq8", 16, 8): 0.9770, ("iq8", 32, 8): 0.9917,
    ("rpq32+rerank", 32, 4): 0.7363, ("rpq32+rerank", 64, 4): 0.8464,
    ("rpq64+rerank", 64, 4): 0.9964, ("rpq64+rerank", 96, 4): 0.9973,
}
# the native `--metric cosine` build served by the engine
# (`docs/PERFORMANCE.md:546, :548`)
ANGULAR_COSINE_JAX_RECALL = {32: 0.9908, 48: 0.9951}
ANGULAR_SLACK, ANGULAR_RPQ32_SLACK = 0.01, 0.03


@contextlib.contextmanager
def _b1_forms_and_build_stages():
    """While active, B1's launcher records the operands of each launch as
    the wrapper hands them over (use_norms, queries, rows, NB), and every
    `build_vamana_knn` call records its stage seconds (with each stage's
    peak device bytes): for a build reached through
    `build_index_from_vectors`, which keeps neither."""
    from diskrag_tpu_torch.graph import knn_build
    from diskrag_tpu_torch.ops import flat_scan as fs

    real_scan, real_build = fs._scan_cuda, knn_build.build_vamana_knn
    got: dict = {"b1": [], "stages": []}

    def scan(q, db, norm_block, nb, use_norms, q_scales, n):
        got["b1"].append({"use_norms": bool(use_norms), "b": q.shape[0], "n": n, "nb": nb})
        return real_scan(q, db, norm_block, nb, use_norms, q_scales, n)

    def build(*a, **kw):
        got["stages"].append(kw.setdefault("stage_seconds", {}))
        return real_build(*a, **kw)

    fs._scan_cuda, knn_build.build_vamana_knn = scan, build
    try:
        yield got
    finally:
        fs._scan_cuda, knn_build.build_vamana_knn = real_scan, real_build


def _angular_gate(key, rec: float, at_cell: bool) -> dict:
    """The row's JAX figure and gate (at the cell's size only); fails the
    run below the gate."""
    ref = ANGULAR_JAX_RECALL.get(key)
    if ref is None or not at_cell:
        return {"jax_package_recorded": ref}
    gate = round(ref - (ANGULAR_RPQ32_SLACK if key[0] == "rpq32+rerank" else ANGULAR_SLACK), 4)
    require(rec >= gate, f"angular {key} recall@10 {rec} < {gate}")
    return {"jax_package_recorded": ref, "recall_gate": gate}


def phase_main_angular(smi: str, base, n: int = ANGULAR_N) -> dict:
    """Cell angular-1.2M-R32: BASELINE config 3, the JAX package's angular
    configuration (`benchmarks/angular_bench.py`), through the port's
    `tools.angular_bench.run` in process on the card: 1.2M unit-normalized
    x 128 (`make_angular_dataset`), the R = 32 kNN build (B1 + B4 once a
    4096-row block), then exact, iq8, rpq32 and rpq64 (2048 cells) over
    that graph at the JAX protocol's widths. The launch counts are read
    around the build and around each quantizer's sweep: B5 once a round in
    the rpq rows, G1 once a search in the exact rows, none in the iq8 rows. Then exact traversal
    at L = 48, B5 by id bit for bit at one real rpq64 round (1000 x 4 x 32
    candidates, m = 64, 2048 cells), B1 and B4 at the cosine build's shape
    (4096 x 1.2M, NB 4096, B1's norm-free form; kk 260), and the native
    cosine build through `build_index_from_vectors(metric="cosine")` (293
    B1 launches, every one norm-free, and 293 B4), served by
    `SearchEngine.search_batch` at l_search 32 / 48 (exact traversal: no
    kernel). Recall@10 is gated at the JAX figures less 0.01 (rpq32: 0.03)
    at 1.2M only; at another `n` the phase measures."""
    import numpy as np
    import torch

    from diskrag_tpu_torch.benchmark import recall_at_k, sweep_exact
    from diskrag_tpu_torch.build_index import build_index_from_vectors
    from diskrag_tpu_torch.engine import SearchEngine
    from diskrag_tpu_torch.graph.search import beam_search_pq
    from diskrag_tpu_torch.tools import angular_bench

    cell = "angular-1.2M-R32" if n == ANGULAR_N else f"angular-{n}-R32"
    at_cell = n == ANGULAR_N
    blocks = -(-n // 4096)
    t_phase = time.perf_counter()

    # 1. the JAX protocol, in process
    keep: dict = {}
    torch.cuda.empty_cache()
    reset_counts()
    with _b1_forms_and_build_stages() as l2_forms:
        result = angular_bench.run(n=n, dim=MAIN_D, n_queries=MAIN_B, k=MAIN_K, device="cuda",
                                   min_seconds=0.5, keep=keep)
    launches = keep["launches"]
    require(launches["build"]["B1"] == launches["build"]["B4"] == blocks
            and not any(v for kid, v in launches["build"].items() if kid not in ("B1", "B4")),
            f"the angular L2 build did not launch B1 and B4 once a block: {launches['build']}")
    require(len(l2_forms["b1"]) == blocks and all(f["use_norms"] for f in l2_forms["b1"]),
            "the L2 build ran B1's norm-free form")
    index, q, gt = keep["index"], keep["queries"], keep["gt"]
    stages = result["stage_seconds"]
    build = {"build_seconds": result["build_seconds"],
             "stage_seconds": {k: v for k, v in stages.items() if k != "peak_device_bytes"},
             "peak_device_bytes_by_stage": stages["peak_device_bytes"],
             "peak_device_bytes": max(stages["peak_device_bytes"].values()),
             "launches": launches["build"], "entry_points": int(index.entry_points.shape[0]),
             "no_in_edge_share": index.no_in_edge_share()}
    emit({"phase": "main-angular", "cell": cell, "step": "build l2", "n": n, "d": MAIN_D,
          "degree_bound": 32, **build, "card": smi})
    rows, rounds_rpq, b5_rpq, g1_launches = [], 0, 0, 0
    for p in keep["sweep_points"]:
        key = (p.mode, p.search_width, p.expand_width)
        row = {"mode": p.mode, "L": p.search_width, "E": p.expand_width,
               "recall_at_10": p.recall, "qps": p.qps,
               "ms_per_batch": p.mean_latency_ms * len(q), "rounds_per_pass": p.rounds,
               "passes": p.passes, **_angular_gate(key, p.recall, at_cell)}
        rows.append(row)
    for group, got in launches.items():
        if group == "build":
            continue
        pts_g = [p for p in keep["sweep_points"] if p.mode.split("+")[0] == group]
        rounds = sum(p.rounds * p.passes for p in pts_g)
        others = {kid: v for kid, v in got.items() if kid != "B5"}
        if group.startswith("rpq"):
            require(got["B5"] == rounds > 0 and not any(others.values()),
                    f"{group}: B5 launches {got} != the rounds executed {rounds}")
            rounds_rpq += rounds
            b5_rpq += got["B5"]
        elif group == "exact":  # L2 on the normalized rows: G1 once a search
            searches = sweep_searches(pts_g, len(q))
            require(got == {**{kid: 0 for kid in got}, **searches_on_the_card(searches)},
                    f"{group}: the traversal launched {got}, expected G1 once a search "
                    f"({searches})")
            g1_launches = got["G1"]
        else:
            require(not any(got.values()), f"{group}: the traversal launched {got}")
    emit({"phase": "main-angular", "cell": cell, "step": "sweeps", "queries": len(q),
          "k": MAIN_K, "points": rows, "launches": {g: v for g, v in launches.items()
                                                    if g != "build"},
          "quantizer_seconds": keep["quantizer_seconds"], "card": smi})

    # 2. exact traversal at L = 48 on the same graph
    reset_counts()
    p48 = sweep_exact(index, q, gt, k=MAIN_K, widths=(48,), expand_widths=(8,),
                      min_seconds=0.5)[0]
    got = read_counts()
    searches = sweep_searches([p48], len(q))
    require(got == {**{kid: 0 for kid in got}, **searches_on_the_card(searches)},
            f"exact L=48 launched {got}, expected G1 once a search ({searches})")
    g1_launches += got["G1"]
    l2_recall = {p.search_width: p.recall for p in keep["sweep_points"] if p.mode == "exact"}
    l2_recall[48] = p48.recall
    emit({"phase": "main-angular", "cell": cell, "step": "exact L=48", "mode": "exact", "L": 48,
          "E": 8, "recall_at_10": p48.recall, "qps": p48.qps,
          "ms_per_batch": p48.mean_latency_ms * len(q), "rounds_per_pass": p48.rounds,
          **_angular_gate(("exact", 48, 8), p48.recall, at_cell), "card": smi})

    # 3. B5 by id at one real rpq64 round: 1000 queries x E * R = 128
    # candidates, m = 64, over the 2048 coarse cells
    rpq, codes, cids = keep["rpq64"]
    qd = torch.as_tensor(q, device="cuda")
    cells = cids.to(torch.int32)
    with _captured_b5_round(2) as op:
        beam_search_pq(codes, rpq.inner_tables(qd), index.adjacency, index.medoid,
                       search_width=64, k=MAIN_K, rerank=True, vectors=index.vectors, queries=qd,
                       expand_width=4, entry_points=index.entry_points, point_cell=cells,
                       point_bias=rpq.point_bias(codes, cells), cell_tables=rpq.cell_tables(qd))
    require(tuple(op["ids"].shape) == (len(q), 4 * 32) and op["tables"].shape[1] == 64
            and op["aux"]["cell_tables"].shape[1] == rpq.n_coarse,
            f"captured round: ids {tuple(op['ids'].shape)}, m {op['tables'].shape[1]}, "
            f"cells {op['aux']['cell_tables'].shape[1]}")
    b5 = {"rows": codes.shape[0], "cells": int(rpq.n_coarse),
          **_b5_compact(b5_ids_row(op["tables"], op["code_table"], op["ids"], op["aux"]))}
    emit({"phase": "main-angular", "cell": cell, "kernel": "B5",
          "operands": "one rpq64 round (L = 64, E = 4)", **b5, "card": smi})
    pts = keep["points"]
    del op, rpq, codes, cids, cells, qd, index, keep
    torch.cuda.empty_cache()

    # 4. B1's norm-free form and B4 at the cosine build's shape
    shape = phase_build_shape_kernels(pts, smi, metric="cosine")

    # 5. the native cosine build, through the entry points a user calls
    index_dir = make_collection(base, "angular_cosine", pts)
    reset_counts()
    t0 = time.perf_counter()
    with _b1_forms_and_build_stages() as cos_forms:
        meta = build_index_from_vectors(pts, index_dir, metric="cosine", index_type="vamana",
                                        params_override={"R": 32}, device="cuda")
    torch.cuda.synchronize()
    cos_seconds = time.perf_counter() - t0
    cos_launches = read_counts()
    norm_forms = sorted({f["use_norms"] for f in cos_forms["b1"]})
    require(cos_launches["B1"] == cos_launches["B4"] == blocks == len(cos_forms["b1"]),
            f"the cosine build did not launch B1 and B4 once a block: {cos_launches}")
    require(norm_forms == [False] and all(f["b"] <= 4096 and f["n"] == n and f["nb"] == 4096
                                          for f in cos_forms["b1"]),
            f"the cosine build's B1 operands: use_norms {norm_forms}")
    require(meta["distance_metric"] == "cosine" and meta["R"] == 32,
            f"cosine build meta: {meta['distance_metric']}, R {meta['R']}")
    cos_stages = cos_forms["stages"][0]
    engine = SearchEngine("angular_cosine", base_dir=str(base), device="cuda")
    require(engine.index.metric == "cosine", "the engine did not load a cosine graph")
    cos_build = {"seconds": cos_seconds, "graph_seconds": meta["build_seconds"],
                 "stage_seconds": {k: v for k, v in cos_stages.items()
                                   if k != "peak_device_bytes"},
                 "peak_device_bytes_by_stage": cos_stages["peak_device_bytes"],
                 "peak_device_bytes": max(cos_stages["peak_device_bytes"].values()),
                 "launches": cos_launches, "b1_forms": {"use_norms": norm_forms,
                                                        "launches": len(cos_forms["b1"])},
                 "pq_kind": meta.get("pq_kind"), "use_pq": meta.get("use_pq"),
                 "no_in_edge_share": engine.index.no_in_edge_share()}
    emit({"phase": "main-angular", "cell": cell, "step": "build cosine", **cos_build,
          "card": smi})
    serve_rows = []
    for width in (32, 48):
        engine.search_batch(q, k=MAIN_K, l_search=width)
        dists, ids, stats, batch_s, got = drive(engine, q, 3, l_search=width)
        require(not any(got.values()), f"cosine engine L={width} launched {got}")
        require(all(s["search_type"] == "exact" for s in stats),
                f"cosine engine served {stats[0]['search_type']}")
        ids, dists = np.asarray(ids), np.asarray(dists, np.float64)
        # 1 - cos in f64 on the returned ids: no sqrt was taken
        v = pts[ids.reshape(-1)].reshape(*ids.shape, -1).astype(np.float64)
        qn = q.astype(np.float64) / np.linalg.norm(q.astype(np.float64), axis=1, keepdims=True)
        want = 1.0 - np.einsum("bd,bkd->bk", qn, v / np.linalg.norm(v, axis=-1, keepdims=True))
        err = float(np.abs(dists - want).max())
        require(bool(np.isfinite(dists).all()) and float(dists.min()) >= -1e-6
                and float(dists.max()) <= 2.0 + 1e-6 and err <= 1e-5
                and bool((np.diff(dists, axis=1) >= 0).all()),
                f"cosine distances at L={width}: range [{dists.min()}, {dists.max()}], "
                f"off 1 - cos by {err}")
        rec = recall_at_k(ids, gt, MAIN_K)
        row = {"mode": "engine-cosine", "L": width, "E": 1, "recall_at_10": rec,
               "l2_on_normalized_recall": l2_recall[width],
               "ms_per_batch": [s * 1e3 for s in batch_s],
               "qps": len(q) / min(batch_s), "rounds": stats[0].get("rounds"),
               "distance_range": [float(dists.min()), float(dists.max())],
               "distance_max_err_vs_1_minus_cos": err, "launches": got,
               "jax_package_recorded": ANGULAR_COSINE_JAX_RECALL[width]}
        if at_cell:
            gate = round(ANGULAR_COSINE_JAX_RECALL[width] - ANGULAR_SLACK, 4)
            require(rec >= gate, f"cosine engine recall@10 {rec} < {gate} at L={width}")
            require(abs(rec - l2_recall[width]) <= ANGULAR_SLACK,
                    f"cosine {rec} and L2 on normalized {l2_recall[width]} differ at L={width}")
            row["recall_gate"] = gate
        serve_rows.append(row)
        emit({"phase": "main-angular", "cell": cell, "step": "engine cosine", **row, "card": smi})
    del engine
    shutil.rmtree(base / "angular_cosine", ignore_errors=True)
    torch.cuda.empty_cache()
    emit({"phase": "main-angular", "cell": cell, "n": n,
          "seconds": time.perf_counter() - t_phase, "card": smi})
    return {"build_launches": {"l2": launches["build"], "cosine": cos_launches},
            "build_shape_cosine": shape, "b5": b5, "b5_launches": b5_rpq, "rounds": rounds_rpq,
            "g1_launches": g1_launches}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (ROOT / "diskrag_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout (diskrag_tpu_torch/ not found)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    dev = phase_device()
    if sys.argv[1:2] in (["--graph-n"], ["--streaming-n"], ["--sharded-n"], ["--host-tier-n"],
                         ["--angular-n"], ["--g1-n"], ["--pq-cell-n"]):
        from diskrag_tpu_torch.benchmark import ground_truth, make_dataset

        n = int(sys.argv[2])
        if sys.argv[1] == "--streaming-n":
            phase_main_streaming(dev["smi"], base_n=n)
        elif sys.argv[1] == "--pq-cell-n":
            cell = phase_pq_cell_kernels(dev["smi"], n)
            print(json.dumps({"kernels": [{"name": "B5", "pq_cell_shape": cell["b5"]},
                                          {"name": "B1, B4",
                                           "pq_cell_build_shape": cell["build_shape"]}]}))
        elif sys.argv[1] == "--g1-n":
            from diskrag_tpu_torch.graph.knn_build import build_vamana_knn

            pts, q = make_dataset(n, MAIN_D, MAIN_B, seed=42)
            gt = ground_truth(pts, q, MAIN_K, device="cuda")
            index = build_vamana_knn(pts, degree_bound=48, alpha=1.2, seed=0, device="cuda")
            rows = g1_rows(dev["smi"], index, q, gt, G1_CELL_SHAPES + G1_SWEEP_SHAPES,
                           f"{n // 1000}k R48")
            g2 = g2_rows(dev["smi"], index, q, G2_CELL_SHAPES, f"{n // 1000}k R48")
            print(json.dumps({"kernels": [g1_kernel_row(rows), g2_kernel_row(g2)]}))
        elif sys.argv[1] == "--angular-n":
            base = ROOT / "build" / "chip_smoke" / "collections"
            shutil.rmtree(base, ignore_errors=True)
            try:
                phase_main_angular(dev["smi"], base, n)
            finally:
                shutil.rmtree(base, ignore_errors=True)
        elif sys.argv[1] == "--host-tier-n":
            t = time.perf_counter()
            pts, q = make_dataset(n, MAIN_D, MAIN_B, seed=42)
            gt = ground_truth(pts, q, MAIN_K, device="cuda")
            emit({"phase": "data", "n": n, "d": MAIN_D, "queries": MAIN_B,
                  "seconds_with_ground_truth": time.perf_counter() - t})
            base = ROOT / "build" / "chip_smoke" / "collections"
            shutil.rmtree(base, ignore_errors=True)
            try:
                phase_host_tier_ladder(dev["smi"], base, pts, q, gt)
            finally:
                shutil.rmtree(base, ignore_errors=True)
        elif sys.argv[1] == "--sharded-n":
            pts, q = make_dataset(n, MAIN_D, MAIN_B, seed=42)
            base = ROOT / "build" / "chip_smoke" / "collections"
            shutil.rmtree(base, ignore_errors=True)
            shards = int(sys.argv[4]) if sys.argv[3:4] == ["--shards"] else SHARDED_SHARDS
            try:
                phase_main_sharded(dev["smi"], base, pts, q,
                                   ground_truth(pts, q, MAIN_K, device="cuda"),
                                   n_shards=shards, full=False)
            finally:
                shutil.rmtree(base, ignore_errors=True)
        else:
            pts, q = make_dataset(n, MAIN_D, MAIN_B, seed=42)
            phase_main_graph(dev["smi"], pts, q, ground_truth(pts, q, MAIN_K, device="cuda"))
        emit({"phase": "done", "seconds": time.perf_counter() - t0})
        print(dev["smi"])
        return 0
    phase_kernels()
    phase_packed_kernels()
    b5_ladder_shapes = phase_b5_kernels()
    pq_cell = phase_pq_cell_kernels(dev["smi"])

    from diskrag_tpu_torch.benchmark import ground_truth, make_dataset

    base = ROOT / "build" / "chip_smoke" / "collections"
    shutil.rmtree(base, ignore_errors=True)
    sets = {}
    for n_pts in (MAIN_N, CMP_N):
        t = time.perf_counter()
        pts, q = make_dataset(n_pts, MAIN_D, MAIN_B, seed=42)
        gt = ground_truth(pts, q, MAIN_K, device="cuda")
        sets[n_pts] = (pts, q, gt)
        emit({"phase": "data", "n": n_pts, "d": MAIN_D, "queries": MAIN_B,
              "seconds_with_ground_truth": time.perf_counter() - t})
    try:
        out = phase_main(dev["smi"], base, *sets[MAIN_N])
        out["kernels"] += phase_main_packed(dev["smi"], base, sets)
        out["kernels"].append(phase_main_bf16(dev["smi"], base, sets))
        m1 = phase_m1_kernels(dev["smi"], sets)
        m1["launches"] = phase_micro(dev["smi"], sets)
        ht1m = phase_host_tier_1m(dev["smi"], base, *sets[MAIN_N])
        for row in out["kernels"][:2]:  # B1, B4: their launches in the 1M host-tier build
            row["launches_host_tier_1m_build"] = ht1m["build_launches"][row["name"][:2]]
        ladder = phase_host_tier_ladder(dev["smi"], base, *sets[MAIN_N])
        for row in out["kernels"][:2]:  # B1, B4: their launches in the ladder's R = 32 build
            row["launches_host_tier_ladder_build"] = ladder["build_launches"][row["name"][:2]]
        phase_ivf(dev["smi"], base, *sets[MAIN_N])
        phase_vamana_ivfknn(dev["smi"], *sets[MAIN_N])
        t = time.perf_counter()
        sharded = phase_main_sharded(dev["smi"], base, *sets[MAIN_N])
        for row in out["kernels"][:2]:  # B1, B4: their launches in the 4 x 250k sharded build
            row["launches_sharded_build"] = sharded["build_launches"][row["name"][:2]]
        phase_sharded_multi(dev["smi"])
        emit({"phase": "main-sharded", "step": "total with dryrun and multihost",
              "seconds": time.perf_counter() - t})
        del sets[MAIN_N]
        angular = phase_main_angular(dev["smi"], base)
        build_shapes = phase_build_shape_kernels(sets[CMP_N][0], dev["smi"])
        for row in out["kernels"][:2]:  # B1, B4: their shapes inside the graph builds
            kid = row["name"][:2]
            row["graph_build_shape"] = build_shapes[kid]
            row["angular_build_shape_cosine"] = angular["build_shape_cosine"][kid]
            row["pq_cell_build_shape"] = pq_cell["build_shape"][kid]
            row["launches_angular_builds"] = {form: angular["build_launches"][form][kid]
                                              for form in ("l2", "cosine")}
        graph = phase_main_graph(dev["smi"], *sets[CMP_N])
        b5 = phase_main_vamana(dev["smi"], base, *sets[CMP_N])
        auto_recall = b5.pop("auto_recall_at_64")
        b5_row = {
            "name": "B5 adc_lookup (ADC lookup of the PQ-guided traversal: by id with the "
                    "residual terms on the main path; the gathered form below)",
            "route": "cuda", "source": "diskrag_tpu_torch/csrc/adc_lookup.cu",
            "replaces": "diskrag_tpu/ops/pq_scan.py:30", **b5,
            "sweep_shape": graph["sweep_shape"],
            "launches_pq_sweep": graph["launches_pq_sweep"],
        }
        out["kernels"].append(b5_row)
        out["kernels"].append(m1)
        g1_row = g1_kernel_row({**ht1m["g1"], **graph["g1"]})
        g1_row["launches_exact_sweep_200k"] = graph["g1_launches_exact_sweep"]
        g1_row["launches_angular_exact"] = angular["g1_launches"]
        out["kernels"].append(g1_row)
        out["kernels"].append(g2_kernel_row(ht1m["g2"]))
        phase_api(dev["smi"], base, "vamana_200k", CMP_N)
        ht200 = phase_host_tier_200k(dev["smi"], base, "vamana_200k", *sets[CMP_N], auto_recall)
        b5_row["launches_host_tier_200k_pq"] = ht200["b5_launches"]
        b5_row["rounds_host_tier_200k_pq"] = ht200["rounds"]
        b5_row["launches_sharded_host_tier_pq"] = sharded["b5_launches"]
        b5_row["ladder_shape"] = {**b5_ladder_shapes, **ladder["b5"]}
        b5_row["launches_host_tier_ladder_rpq64"] = ladder["b5_launches"]
        b5_row["rounds_host_tier_ladder_rpq64"] = ladder["rounds"]
        b5_row["rounds_sharded_host_tier_pq"] = sharded["rounds"]
        b5_row["angular_shape"] = angular["b5"]
        b5_row["pq_cell_shape"] = pq_cell["b5"]
        b5_row["launches_angular_rpq"] = angular["b5_launches"]
        b5_row["rounds_angular_rpq"] = angular["rounds"]
        phase_ivf(dev["smi"], base, *sets[CMP_N])
        phase_ivfknn_resume(dev["smi"], sets[CMP_N][0])
        streaming = phase_main_streaming(dev["smi"])
        for row in out["kernels"][:2]:  # B1, B4: the streaming merge's shape and launches
            kid = row["name"][:2]
            row["streaming_merge_shape"] = streaming["kernels"][kid]
            row["launches_main_streaming_merges"] = streaming["launches"][kid]
            row["launches_per_streaming_merge"] = streaming["launches"][kid] // streaming["n_merges"]
        g1_row["launches_main_streaming"] = streaming["g1_searches"]
        g1_row["launches_streaming_wave_merge"] = streaming["g1_wave_merge"]
        g1_row["launches_wave_build"] = phase_main_wave(dev["smi"], base, *sets[CMP_N])
        g1_row["launches_api_streaming"] = phase_api_streaming(dev["smi"], base, "vamana_200k",
                                                               CMP_N, sets[CMP_N][1])
    finally:
        shutil.rmtree(base, ignore_errors=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(json.dumps({"kernels": out["kernels"]}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
