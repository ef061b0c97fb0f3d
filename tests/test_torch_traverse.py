"""G2 and G1 (`ops/traverse.py`, `csrc/beam_seed.cu`,
`csrc/beam_traverse.cu`): the exact search's seeding and its rounds, each
in one CUDA kernel.

On the CPU: which exact searches go to the kernels (`refusal`; a refused
search keeps the plain seeding and round loop and launches nothing), G2's
grid plan and both wrappers' checks. The tests marked `cuda` (they skip
without a card) hold G2 against the plain seeding and G1 against the plain
rounds from the same seeded state on a card:

    pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_traverse.py

No JAX in this file: the tests for the card hold the kernels against the
port's own plain seeding and rounds (`--noconftest` skips the suite's session hook,
which asks JAX for emulated CPU devices these tests do not need)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

from diskrag_tpu_torch.benchmark import ground_truth, make_dataset, recall_at_k
from diskrag_tpu_torch.graph import search as tsearch
from diskrag_tpu_torch.kernels.launches import launch_counts, reset_launch_counts
from diskrag_tpu_torch.ops import traverse
from diskrag_tpu_torch.ops.distance import pairwise_distance
from diskrag_tpu_torch.utils import profiling


def _random_graph(n=300, d=16, r=12, b=8, seed=0):
    rng = np.random.default_rng(seed)
    vecs = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    adj = torch.from_numpy(rng.integers(-1, n, size=(n, r)).astype(np.int32))
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    return vecs, adj, q


# (case, what it changes, the refusal's words)
REFUSED = [
    ("cpu", {}, "CUDA device"),
    ("bf16", {"dtype": torch.bfloat16}, "f32"),
    ("dim_not_multiple_of_4", {"d": 18}, "multiple of 4"),
    ("dim_over_2048", {"d": 2052}, "multiple of 4 up to 2048"),
    ("width_over_256", {"width": 264}, "E <= L <= 256"),
    ("fresh_over_1024", {"width": 128, "e": 100}, "E x R"),
    ("visited_over_1024", {"e": 8, "max_steps": 200}, "max_steps x E"),
    ("cosine", {"metric": "cosine"}, "L2"),
    ("int64_adjacency", {"adj_dtype": torch.int64}, "int32"),
    ("strided_vectors", {"strided": True}, "contiguous"),
]


@pytest.mark.parametrize("case,change,words", REFUSED, ids=[c[0] for c in REFUSED])
def test_refused_searches_keep_the_plain_loop(case, change, words):
    """Each input outside G1's reach keeps `_seed_candidates` and
    `_plain_rounds`: the refusal names why, the search seeds and runs the
    plain rounds (their spans and counters record) and neither G2's nor
    G1's launch count, `graph.seed_kernel` nor `graph.traverse_kernel`
    moves."""
    vecs, adj, q = _random_graph(d=change.get("d", 16))
    vecs = vecs.to(change.get("dtype", torch.float32))
    if change.get("strided"):
        vecs = torch.cat([vecs, vecs], dim=1)[:, ::2]
    adj = adj.to(change.get("adj_dtype", torch.int32))
    kw = dict(search_width=change.get("width", 16), expand_width=change.get("e", 1),
              metric=change.get("metric", "l2"))
    steps = change.get("max_steps") or tsearch._default_steps(kw["search_width"],
                                                              kw["expand_width"], 10, None)
    why = traverse.refusal(vecs, adj, q, max_steps=steps, **kw)
    assert why is not None and words in why, why
    reset_launch_counts()
    with profiling.tracing():
        profiling.counters(reset=True)
        res = tsearch.beam_search(vecs, adj, torch.tensor(0, dtype=torch.int32), q,
                                  k=10, max_steps=change.get("max_steps"), **kw)
        records = profiling.drain()
        counters = profiling.counters(reset=True)
    assert launch_counts()["G1"] == launch_counts()["G2"] == 0
    assert "graph.traverse_kernel" not in counters and counters["graph.rounds"] == int(res.n_steps)
    assert "graph.seed_kernel" not in counters
    assert any(r.name == "graph.seed" for r in records)
    assert any(r.name == "graph.round" for r in records)
    assert not any(r.name == "graph.traverse" for r in records)


def _seeded(vecs, adj, q, l=16):
    b = q.shape[0]
    ids = torch.full((b, l), -1, dtype=torch.int32)
    ids[:, 0] = 0
    dists = torch.full((b, l), float("inf"))
    dists[:, 0] = 1.0
    return [vecs, adj, q, ids, dists, ids == -1]


# (case, operand index, replacement maker, exception, words)
WRAPPER = [
    ("f64_vectors", 0, lambda a: a.double(), TypeError, "float32 vectors"),
    ("int64_cand_ids", 3, lambda a: a.long(), TypeError, "int32 cand_ids"),
    ("uint8_expanded", 5, lambda a: a.to(torch.uint8), TypeError, "bool expanded"),
    ("query_width", 2, lambda a: a[:, :8].contiguous(), ValueError, "disagree"),
    ("adjacency_rows", 1, lambda a: a[:-1], ValueError, "disagree"),
    ("cand_dists_shape", 4, lambda a: a[:, :-1], ValueError, "disagree"),
    ("expanded_rows", 5, lambda a: a[:-1], ValueError, "disagree"),
    ("cpu_operands", 0, lambda a: a, ValueError, "one CUDA device"),
]


@pytest.mark.parametrize("case,at,make,exc,words", WRAPPER, ids=[c[0] for c in WRAPPER])
def test_wrapper_refuses_operands_it_does_not_take(case, at, make, exc, words):
    ops = _seeded(*_random_graph())
    ops[at] = make(ops[at])
    reset_launch_counts()
    with pytest.raises(exc, match=words):
        traverse.beam_traverse(*ops, expand_width=1, max_steps=32)
    assert launch_counts()["G1"] == 0


def _guided(kind):
    """A PQ- or int-guided search on the CPU, the plain seeding's other callers."""
    from diskrag_tpu_torch.pq.intq import IntQuantizer

    vecs, adj, q = _random_graph()
    med = torch.tensor(0, dtype=torch.int32)
    kw = dict(search_width=16, k=10, vectors=vecs, queries=q, expand_width=2,
              entry_points=torch.arange(1, 40, dtype=torch.int32))
    if kind == "pq":
        gen = torch.Generator().manual_seed(0)
        codes = torch.randint(0, 256, (vecs.shape[0], 4), dtype=torch.uint8, generator=gen)
        tables = torch.rand((q.shape[0], 4, 256), generator=gen)
        return tsearch.beam_search_pq(codes, tables, adj, med, **kw)
    iq = IntQuantizer(bits=8, device="cpu").fit(vecs.numpy(), seed=0)
    rows = torch.as_tensor(iq.encode(vecs.numpy()))
    return tsearch.beam_search_iq(rows, iq.query_tables(q), adj, med, dim=iq.dim, bits=iq.bits,
                                  n_cells=iq.n_cells, **kw)


@pytest.mark.parametrize("kind", ["pq", "iq"])
def test_guided_searches_keep_the_plain_seeding(kind):
    """The PQ- and int-guided searches seed with `_seed_candidates` (one
    `graph.seed` span a search) and launch neither kernel."""
    reset_launch_counts()
    with profiling.tracing():
        profiling.counters(reset=True)
        res = _guided(kind)
        records = profiling.drain()
        counters = profiling.counters(reset=True)
    assert res.ids.shape == (8, 10)
    assert launch_counts()["G1"] == launch_counts()["G2"] == 0
    assert "graph.seed_kernel" not in counters and "graph.traverse_kernel" not in counters
    assert sum(r.name == "graph.seed" for r in records) == 1


# (case, B, S, L, D): the exact cells' shapes (1M x 128: 15,625 entry points
# and the medoid), the wave build's (the medoid alone at B 2048), a width
# of 256 and D 2048
PLANS = [
    ("exact_b1", 1, 15_626, 32, 128),
    ("exact_b512", 512, 15_626, 32, 128),
    ("wave_medoid_only", 2048, 1, 64, 128),
    ("wave_entry_points", 2048, 3_126, 64, 128),
    ("b7_l256", 7, 15_626, 256, 128),
    ("d2048", 512, 15_626, 32, 2048),
    ("few_seeds", 3, 6, 32, 36),
]


@pytest.mark.parametrize("case,b,s,l,d", PLANS, ids=[c[0] for c in PLANS])
def test_seed_plan_takes_the_grid_from_the_shapes(case, b, s, l, d):
    """G2's grid: tiles of a power of two queries, as many as B needs (16 at
    most) within the tile's shared-memory room; slices that cover the seeds
    with none empty, about two blocks an SM and at most 4096 list keys a
    query; one slice, unsorted, where S < L."""
    sms = 132
    qt, tiles, ns = traverse.seed_plan(b, s, l, d, sms)
    assert qt & (qt - 1) == 0 and qt <= traverse.SEED_TILE
    assert traverse.seed_tile_bytes(qt, d, l) <= traverse.SEED_TILE_BYTES
    assert tiles == -(-b // qt) and (qt >= min(b, traverse.SEED_TILE)
                                     or traverse.seed_tile_bytes(2 * qt, d, l)
                                     > traverse.SEED_TILE_BYTES)
    sl = -(-s // ns)
    assert (ns - 1) * sl < s <= ns * sl
    if s < l:
        assert ns == 1
    else:
        assert ns * l <= traverse.SEED_MERGE_KEYS and tiles * ns <= 2 * sms or ns == 1
    if case == "exact_b1":  # the seeds spread over nearly every SM
        assert (qt, ns) == (1, 123)
    if case == "exact_b512":  # each seed row read 32 times, not 512
        assert (qt, tiles, ns) == (16, 32, 8)


# (case, operand, replacement, exception, words)
SEED_WRAPPER = [
    ("f64_vectors", "vectors", lambda a: a.double(), TypeError, "float32 vectors"),
    ("bf16_queries", "queries", lambda a: a.bfloat16(), TypeError, "float32 vectors"),
    ("float_medoid", "medoid", lambda a: a.float(), TypeError, "integer medoid"),
    ("1d_medoid", "medoid", lambda a: a[None], TypeError, "integer medoid"),
    ("int64_entry_points", "entry_points", lambda a: a.long(), TypeError, "int32 entry_points"),
    ("2d_entry_points", "entry_points", lambda a: a[None], TypeError, "int32 entry_points"),
    ("query_width", "queries", lambda a: a[:, :8].contiguous(), ValueError, "disagree"),
    ("dim_not_multiple_of_4", "both", lambda a: a[..., :18].contiguous(), ValueError,
     "multiple of 4"),
    ("width_0", "width", lambda a: 0, ValueError, "L from 1 to 256"),
    ("width_257", "width", lambda a: 257, ValueError, "L from 1 to 256"),
    ("strided_vectors", "vectors", lambda a: torch.cat([a, a], 1)[:, ::2], ValueError,
     "contiguous"),
    ("cpu_operands", "none", lambda a: a, ValueError, "one CUDA device"),
]


@pytest.mark.parametrize("case,at,make,exc,words", SEED_WRAPPER, ids=[c[0] for c in SEED_WRAPPER])
def test_seed_wrapper_refuses_operands_it_does_not_take(case, at, make, exc, words):
    vecs, _, q = _random_graph(d=20)
    ops = {"vectors": vecs, "queries": q, "medoid": torch.tensor(3, dtype=torch.int32),
           "entry_points": torch.arange(10, 40, dtype=torch.int32), "width": 16}
    if at == "both":
        ops["vectors"], ops["queries"] = make(ops["vectors"]), make(ops["queries"])
    elif at != "none":
        ops[at] = make(ops[at])
    reset_launch_counts()
    with pytest.raises(exc, match=words):
        traverse.beam_seed(ops["vectors"], ops["queries"], ops["medoid"], ops["entry_points"],
                           search_width=ops["width"])
    assert launch_counts()["G2"] == 0


# --- on the card ---------------------------------------------------------------
#
# Two sets at the exact cell's widths (D = 128, the R = 48 graph built on the
# card with its entry points), 20k points and 512 queries each. On small
# integers every f32 product and sum is exact in any order, so G1 and the
# plain rounds agree bit for bit on every row, ties and all. On the SIFT-like
# float set (`make_dataset`) the two sum in other orders: each distance of
# the norm expansion max(qn + vn - 2 q.v, 0) is rounded at the scale of
# qn + vn (the two differ by up to 4.1e-7 of it, 1.2e-4 of the distance, on
# an H100), and a near-tie within that rounding can expand in the other
# order; there the criteria are statistical.

N_CARD = 20_000


@pytest.fixture(scope="module")
def card_sets():
    """{"ints": ..., "floats": ...}, each (index, queries on the card, exact
    top-10 ids)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: G1 is compiled and run only on one")
    from diskrag_tpu_torch.graph.knn_build import build_vamana_knn

    rng = np.random.default_rng(5)
    centers = rng.integers(-6, 7, size=(64, 128))
    ints = (centers[rng.integers(0, 64, size=N_CARD)]
            + rng.integers(-2, 3, size=(N_CARD, 128))).astype(np.float32)
    q_int = (ints[rng.integers(0, N_CARD, size=512)]
             + rng.integers(-1, 2, size=(512, 128))).astype(np.float32)
    floats, q_flt = make_dataset(N_CARD, 128, 512, seed=11)
    out = {}
    for name, pts, qs in (("ints", ints, q_int), ("floats", floats, q_flt)):
        index = build_vamana_knn(pts, degree_bound=48, seed=0, device="cuda")
        out[name] = (index, torch.from_numpy(qs).cuda(), ground_truth(pts, qs, 10, device="cuda"))
    return out


def _both(vectors, adjacency, medoid, queries, *, width, e, entry_points, k, max_steps=None):
    """(G1's result, the plain rounds' result) of one search from the same
    seeding; G1 launched exactly once."""
    kw = dict(search_width=width, k=k, expand_width=e, entry_points=entry_points)
    reset_launch_counts()
    kern = tsearch.beam_search(vectors, adjacency, medoid, queries, max_steps=max_steps, **kw)
    assert launch_counts()["G1"] == 1

    def expand(ids):
        return tsearch._gathered_distance(queries, vectors[ids], "l2")

    def seed_expand(seeds):
        return pairwise_distance(queries, vectors[seeds], "l2")

    steps = tsearch._default_steps(width, e, k, max_steps)
    plain = tsearch._frontier_search(adjacency, medoid, expand, queries.shape[0],
                                     max_steps=steps, seed_expand_fn=seed_expand, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["G1"] == 1
    return kern, plain


def _padded(adjacency, width=64, seed=3):
    """The R = 48 rows padded with -1 to `width`, and a tenth of the rest
    knocked out to -1 too."""
    n, r = adjacency.shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    adj = torch.cat([adjacency, torch.full((n, width - r), -1, dtype=torch.int32,
                                           device="cuda")], 1)
    return torch.where(torch.rand(adj.shape, device="cuda", generator=gen) < 0.1, -1,
                       adj).contiguous()


# (case, batch, L, E, entry points, max_steps, padded adjacency)
CARD_CASES = [
    ("cell_b1", 1, 32, 1, "all", None, False),
    ("cell_b7", 7, 32, 1, "all", None, False),
    ("cell_b512", 512, 32, 1, "all", None, False),
    ("wave_l64_e8_r64", 512, 64, 8, "all", None, True),
    ("cap_hit", 512, 32, 1, "all", 6, False),
    ("medoid_only", 512, 32, 1, None, None, False),
    ("five_entry_points", 512, 32, 4, "five", None, False),
]


def _case(sets, name, case):
    _, b, width, e, eps, max_steps, padded = case
    index, qs, gt = sets[name]
    adj = _padded(index.adjacency) if padded else index.adjacency
    ep = {"all": index.entry_points, "five": index.entry_points[:5], None: None}[eps]
    return index, adj, qs[:b], gt[:b], dict(width=width, e=e, entry_points=ep,
                                            max_steps=max_steps)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_g1_is_the_plain_rounds_bit_for_bit_on_integer_data(card_sets, case):
    """Where no sum rounds, G1 is the plain rounds on every row: the whole
    beam (ids and distances), the visited log, n_expanded and n_steps."""
    index, adj, qs, _, kw = _case(card_sets, "ints", case)
    kern, plain = _both(index.vectors, adj, index.medoid, qs, k=kw["width"], **kw)
    for field in ("ids", "dists", "visited_ids", "visited_dists", "n_expanded", "n_steps"):
        assert torch.equal(getattr(kern, field), getattr(plain, field)), field
    assert int(kern.n_steps) > 0
    if case[0] == "cap_hit":
        assert int(kern.n_steps) == 6 and bool((kern.n_expanded == 6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_g1_matches_plain_rounds_on_float_data(card_sets, case):
    """On the SIFT-like set: the top-10 ids identical and the visited logs
    equal as sets each on >= 99.5% of rows (every row at B = 1 and 7);
    on the rows where both hold, n_expanded equal and each distance of the
    top 10 and of the log within 1e-5 of qn + vn, the scale its rounding
    is taken at; recall@10 within 1e-3 and n_steps equal. A near-tie that
    breaks the other way can change which node a round expands while the
    top 10 stays: the share of rows allows for that, the integer test
    holds the logic bit for bit."""
    index, adj, qs, gt, kw = _case(card_sets, "floats", case)
    kern, plain = _both(index.vectors, adj, index.medoid, qs, k=10, **kw)
    same = (kern.ids == plain.ids).all(1)
    k_log, k_order = torch.sort(kern.visited_ids, dim=1)
    p_log, p_order = torch.sort(plain.visited_ids, dim=1)
    logs = (k_log == p_log).all(1)
    for share in (same, logs):
        assert share.float().mean().item() >= 0.995, (
            f"top-10 ids differ on {int((~same).sum())}, visited sets on {int((~logs).sum())} "
            f"of {len(same)} rows")
    both = same & logs
    assert torch.equal(kern.n_expanded[both], plain.n_expanded[both])
    got = recall_at_k(kern.ids.cpu().numpy(), gt, 10)
    want = recall_at_k(plain.ids.cpu().numpy(), gt, 10)
    assert abs(got - want) <= 1e-3, (got, want)
    assert int(kern.n_steps) == int(plain.n_steps) > 0
    for kd, pd, ids in ((kern.dists[both], plain.dists[both], plain.ids[both]),
                        (torch.gather(kern.visited_dists, 1, k_order)[both],
                         torch.gather(plain.visited_dists, 1, p_order)[both], p_log[both])):
        fin = torch.isfinite(pd)
        assert torch.equal(fin, torch.isfinite(kd))
        v = index.vectors[ids.clamp_min(0).long()]
        scale = (qs[both] ** 2).sum(1, keepdim=True) + (v * v).sum(-1)
        assert torch.all((kd - pd).abs()[fin] <= 1e-5 * scale[fin])


@pytest.mark.cuda
def test_an_exact_search_at_the_cells_shape_is_one_traverse_span(card_sets):
    """With tracing on, the search at L 32 / E 1 / R 48 / D 128 records one
    `graph.seed` span and one `graph.traverse` span, `graph.seed_kernel`
    and `graph.traverse_kernel` count it, and no host round
    (`graph.round*`, `graph.rounds`) runs."""
    index, qs, _ = card_sets["floats"]
    reset_launch_counts()
    with profiling.tracing():
        profiling.counters(reset=True)
        tsearch.beam_search(index.vectors, index.adjacency, index.medoid, qs[:1], search_width=32,
                            k=10, entry_points=index.entry_points)
        torch.cuda.synchronize()
        records = profiling.drain()
        counters = profiling.counters(reset=True)
    assert launch_counts()["G1"] == launch_counts()["G2"] == 1
    assert counters.get("graph.traverse_kernel") == counters.get("graph.seed_kernel") == 1
    assert "graph.rounds" not in counters
    assert sum(r.name == "graph.traverse" for r in records) == 1
    assert sum(r.name == "graph.seed" for r in records) == 1
    assert not any(r.name.startswith("graph.round") for r in records)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 512])
def test_the_exact_search_on_the_card_is_two_launches_and_no_pytorch_kernel(card_sets, b):
    """Under the profiler, an exact search at the cells' shape (L 32, E 1, R
    48, D 128, the index's entry points) runs two kernels on the device, G2
    and then G1, and nothing else: no PyTorch kernel seeds it. G2's launch
    lies inside the `graph.seed` range and G1's inside `graph.traverse`."""
    from torch.profiler import ProfilerActivity, profile

    index, qs, _ = card_sets["floats"]

    def search():
        return tsearch.beam_search(index.vectors, index.adjacency, index.medoid, qs[:b],
                                   search_width=32, k=10, entry_points=index.entry_points)

    search()
    torch.cuda.synchronize()
    with profiling.tracing(), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
        search()
        torch.cuda.synchronize()
    profiling.drain()
    events = prof.events()
    kernels = [e.name for e in sorted(events, key=lambda e: e.time_range.start)
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(profiling.PREFIX)]  # the spans' ranges on the device
    assert len(kernels) == 2, kernels
    assert "beam_seed_kernel" in kernels[0] and "beam_traverse_kernel" in kernels[1], kernels
    ranges = {e.name: e.time_range for e in events if e.name.startswith(profiling.PREFIX)
              and e.device_type == torch.autograd.DeviceType.CPU}
    launches = sorted((e.time_range for e in events if e.name == "cudaLaunchKernel"),
                      key=lambda r: r.start)
    assert len(launches) == 2, launches
    for name, launch in zip(("graph.seed", "graph.traverse"), launches):
        span_range = ranges[profiling.PREFIX + name]
        assert span_range.start <= launch.start and launch.end <= span_range.end, name


def _seed_both(vectors, queries, medoid, entry_points, width):
    """(G2's seeded list, `_seed_candidates`'s) of one search; G2 launched
    exactly once."""
    reset_launch_counts()
    got = traverse.beam_seed(vectors, queries, medoid, entry_points, search_width=width)
    torch.cuda.synchronize()
    assert launch_counts()["G2"] == 1 and launch_counts()["G1"] == 0

    def seed_expand(seeds):
        return pairwise_distance(queries, vectors[seeds], "l2")

    want = tsearch._seed_candidates(vectors.new_zeros((1, 1), dtype=torch.int32), medoid, None,
                                    queries.shape[0], search_width=width,
                                    entry_points=entry_points, seed_expand_fn=seed_expand)
    return got, want


# (case, batch, L, seeds): "all" the index's entry points (313 seeds at 20k
# points: S >= L up to L 256), "none" the medoid alone and "five" five entry
# points (S < L: position order, padded), "repeat" 30 entry points and the
# medoid once more (S = L = 32: sorted, the repeat last at +inf, id -1),
# "repeat_few" five and the medoid (S < L: the repeat in its position),
# "ties" every vector twice (each seed distance tied with its twin's, the
# lower position first)
G2_CASES = [
    ("b1_all", 1, 32, "all"),
    ("b512_all", 512, 32, "all"),
    ("b7_l256", 7, 256, "all"),
    ("b1_medoid_only", 1, 32, "none"),
    ("b512_medoid_only", 512, 32, "none"),
    ("b512_five", 512, 32, "five"),
    ("b1_medoid_repeated", 1, 32, "repeat"),
    ("b512_medoid_repeated", 512, 32, "repeat"),
    ("b512_medoid_repeated_few", 512, 32, "repeat_few"),
    ("b1_ties", 1, 32, "ties"),
    ("b512_ties", 512, 32, "ties"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", G2_CASES, ids=[c[0] for c in G2_CASES])
def test_g2_is_the_plain_seeding_bit_for_bit_on_integer_data(card_sets, case):
    """Where no sum rounds, G2's seeded list is `_seed_candidates`'s on every
    row: ids, distances and expanded flags."""
    _, b, width, seeds = case
    index, qs, _ = card_sets["ints"]
    vectors, ep = index.vectors, index.entry_points
    if seeds == "ties":
        vectors = vectors.clone()
        vectors[ep[1::2].long()] = vectors[ep[0::2][: ep[1::2].numel()].long()]
    ep = {"none": None, "five": ep[:5], "repeat": torch.cat([ep[:30], index.medoid[None]]),
          "repeat_few": torch.cat([ep[:5], index.medoid[None]])}.get(seeds, ep)
    got, want = _seed_both(vectors, qs[:b], index.medoid, ep, width)
    for name, g, w in zip(("cand_ids", "cand_dists", "expanded"), got, want):
        assert torch.equal(g, w), name
    if seeds == "ties":
        d = want[1]
        assert bool((d[:, 1:] == d[:, :-1]).any())  # the lists hold ties
    if seeds.startswith("repeat"):  # the repeat scores +inf: id -1 in every row
        assert bool((want[0] == -1).any(1).all()) and bool(torch.isinf(want[1]).any(1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 512])
def test_search_on_g2_matches_the_plain_seeding_on_float_data(card_sets, b):
    """On the SIFT-like set the whole `beam_search` (G2, then G1) against
    the plain seeding and G1 from it: the top-10 ids identical on >= 99.5%
    of rows (every row at B = 1). G2 sums in another order than PyTorch's
    product, so a near-tie among the seeds may order the other way."""
    index, qs, gt = card_sets["floats"]
    qs = qs[:b]
    steps = tsearch._default_steps(32, 1, 10, None)
    kern = tsearch.beam_search(index.vectors, index.adjacency, index.medoid, qs, search_width=32,
                               k=10, entry_points=index.entry_points)
    _, want = _seed_both(index.vectors, qs, index.medoid, index.entry_points, 32)
    plain = traverse.beam_traverse(index.vectors, index.adjacency, qs, *want, expand_width=1,
                                   max_steps=steps)
    same = (kern.ids == plain[0][:, :10]).all(1).float().mean().item()
    assert same >= (1.0 if b < 200 else 0.995), same
    got = recall_at_k(kern.ids.cpu().numpy(), gt[:b], 10)
    ref = recall_at_k(plain[0][:, :10].cpu().numpy(), gt[:b], 10)
    assert abs(got - ref) <= 1e-3, (got, ref)


@pytest.mark.cuda
def test_refused_search_on_the_card_launches_nothing(card_sets):
    """bf16 vectors and L past 256 on the card keep the plain seeding and
    rounds."""
    index, qs, _ = card_sets["floats"]
    reset_launch_counts()
    tsearch.beam_search(index.vectors.to(torch.bfloat16), index.adjacency, index.medoid,
                        qs[:4], search_width=32, k=10, entry_points=index.entry_points)
    tsearch.beam_search(index.vectors, index.adjacency, index.medoid, qs[:4], search_width=264,
                        k=10, max_steps=2, entry_points=index.entry_points)
    torch.cuda.synchronize()
    assert launch_counts()["G1"] == launch_counts()["G2"] == 0
