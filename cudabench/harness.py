"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the reference, and the result line.

Everything a cell is made of is found by name from `BENCHMARK.json`: the
configuration in the file its `configs` entry names, the traffic mix in
`traffic/<traffic>.json`, and each metric's reader in
`metrics/<metric>.py` (a module with `read(run) -> float | None`; None
leaves the metric out of the line). The program under test is
`diskrag_tpu_torch`; the window drives `SearchEngine.search_many`.

A `--trace 1` run, after the window, runs the harness's profiled stretch,
then the program's own span stretches (`program_spans`) on the request
numbers past it, kept as `run.program`; the `--trace 0` run runs neither.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import pathlib
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from cudabench import check, datagen, program_spans, roofline, trace, traffic
from cudabench.reference import ControlEngine

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diskrag_tpu")
COLLECTION = "bench"
# traversal codes the build knows: none, IntQuantizer bits 8, ResidualPQ
TRAVERSAL_CODES = (None, "iq8", "rpq")
# requests of a traced run's span stretch
SPAN_REQUESTS = 64


class Spans:
    """Host-clock spans of the set-up's stages, in order."""

    def __init__(self):
        self.items: list[tuple[str, float]] = []

    def add(self, name: str, seconds: float) -> None:
        self.items.append((name, seconds))

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        yield
        self.add(name, time.perf_counter() - t0)


class GcWatch:
    """Collections of the interpreter's cyclic garbage collector, by
    generation: how many ran and the seconds they took."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._t = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.count[info["generation"]] += 1
            self.seconds[info["generation"]] += time.perf_counter() - self._t


def cpu_seconds() -> float:
    """CPU seconds the process has used, all its threads."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def gc_census() -> dict:
    """Objects the garbage collector tracks and the seconds of one full
    collection, taken so that every window starts from a collected heap."""
    tracked = len(gc.get_objects())
    t0 = time.perf_counter()
    gc.collect()
    return {"tracked": tracked, "full_collect_s": time.perf_counter() - t0}


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, cell: dict, cfg: dict, mix: dict):
        self.cell, self.config, self.traffic = cell, cfg, mix
        self.requests: list[dict] = []
        self.window_s = 0.0
        self.setup_s = None
        self.build_s = None
        self.build_stages: dict = {}
        self.launches: dict = {}
        self.knn_profile: dict | None = None
        self.recall = None
        self.gc: GcWatch | None = None
        self.stretch: dict | None = None
        self.cpu_s = None
        # seconds of each set-up stage by the host clock (the summary's `setup_spans`)
        self.setup_spans: dict = {}
        # the program's spans and counters of a traced run, as
        # `program_spans.span_stretch` gives them, with the profiled span
        # stretch under "profiled" on a card; None untraced or without
        # the program's recorder
        self.program: dict | None = None

    @property
    def answered(self) -> list[dict]:
        return [r for r in self.requests if r["error"] is None]


def load_spec(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def check_config(cfg: dict, path) -> None:
    """Refuses, before any set-up, a configuration that the harness could
    not build or that its reference could not judge: the reference and
    `check.py` hold answers against L2 alone."""
    if cfg.get("metric") != "l2":
        raise ValueError(f"{path}: metric {cfg.get('metric')!r}: the reference judges 'l2' alone")
    codes = cfg.get("traversal_codes")
    if codes not in TRAVERSAL_CODES:
        raise ValueError(f"{path}: unknown traversal_codes {codes!r} "
                         f"(known: {', '.join(map(repr, TRAVERSAL_CODES))})")
    if codes == "rpq":
        for key in ("pq_subvectors", "pq_cells"):
            if key not in cfg:
                raise ValueError(f"{path}: traversal_codes 'rpq' needs {key!r}")


def cell_metrics(spec: dict, cell: str, per_layer: bool) -> list[dict]:
    """The metrics a cell reports: the end-to-end ones (or, with
    `per_layer`, the per-layer ones) whose `workloads` name it, or that
    have no `workloads` and move a metric the cell reports."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not per_layer:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def reader(name: str, root: pathlib.Path = ROOT):
    path = root / "cudabench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cudabench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    return {"nvidia_smi": out}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _build(cfg: dict, pts: np.ndarray, index_dir: pathlib.Path, dev: torch.device,
           run: Run, spans: Spans) -> None:
    """The port's index build, from the host vectors to the index
    persisted in the collection directory."""
    from diskrag_tpu_torch.graph.knn_build import build_vamana_knn
    from diskrag_tpu_torch.index.persist import save_index
    from diskrag_tpu_torch.kernels.launches import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    reset_launch_counts()
    stages: dict = {}
    index = build_vamana_knn(pts, degree_bound=int(cfg["degree_bound"]),
                             alpha=float(cfg["alpha"]), seed=int(cfg["build_seed"]),
                             device=dev, stage_seconds=stages)
    run.launches = launch_counts()
    run.build_stages = stages
    for name in ("entry_points", "knn", "prune", "reverse", "merge"):
        if name in stages:
            spans.add(f"build.{name}", stages[name])
    t1 = time.perf_counter()
    meta = {"recommended_search_L": int(cfg["recommended_search_L"])}
    if "expand_width" in cfg:
        meta["recommended_expand_width"] = int(cfg["expand_width"])
    kwargs: dict = {}
    codes = cfg.get("traversal_codes")
    if codes == "iq8":
        from diskrag_tpu_torch.pq.intq import IntQuantizer

        iq = IntQuantizer(bits=8, device=dev).fit(pts, seed=int(cfg["build_seed"]))
        kwargs = {"pq": iq, "pq_codes": iq.encode(pts)}
    elif codes == "rpq":
        # as `build_index.py::_train_pq` fits a "residual" quantizer
        from diskrag_tpu_torch.pq.residual import ResidualPQ

        rpq = ResidualPQ(n_subvectors=int(cfg["pq_subvectors"]), n_coarse=int(cfg["pq_cells"]),
                         device=dev).fit(pts, seed=int(cfg["build_seed"]))
        pq_codes, cells = rpq.encode(pts)
        kwargs = {"pq": rpq, "pq_codes": pq_codes, "pq_coarse_ids": cells}
    elif codes is not None:
        raise ValueError(f"unknown traversal_codes {codes!r}")
    save_index(index_dir, index, meta_extra=meta, write_compat=bool(cfg["record_file"]),
               host_vectors=pts, **kwargs)
    del index
    _sync(dev)
    spans.add("build.codes_and_save", time.perf_counter() - t1)
    run.build_s = time.perf_counter() - t0


def _profiled_knn_pass(cfg: dict, pts: np.ndarray, dev: torch.device) -> dict:
    """The build's kNN pass (`knn_build.exact_knn`, where B1 and B4 run)
    once more over the same points at the build's shapes, under the
    profiler (device only): the device events of B1 and B4 and the
    launches. Run after the window: once the profiler has run in a
    process, host-bound work there runs some 20% slower, so profiling the
    set-up's own build would slow its later stages and the window."""
    from diskrag_tpu_torch.graph.knn_build import exact_knn
    from diskrag_tpu_torch.kernels.launches import launch_counts, reset_launch_counts

    vectors = torch.as_tensor(pts, device=dev)
    _, knn_k, _ = roofline.knn_params(int(cfg["n"]), int(cfg["degree_bound"]))
    reset_launch_counts()
    with trace.profiling(host=False) as prof:
        exact_knn(vectors, knn_k, metric=cfg["metric"], query_block=roofline.KNN_QUERY_BLOCK)
        torch.cuda.synchronize(dev)
    launches = launch_counts()
    return {"kernels": trace.knn_kernels(trace.split_events(prof)[0]),
            "launches": {"B1": launches["B1"], "B4": launches["B4"]}}


def _consume(stream: traffic.RequestStream, k: int, keep: np.ndarray):
    """Takes a request's answer: its stats and its results as arrays; the
    full results of the seeded sample of requests in `keep`."""

    def consume(rec: dict, out) -> None:
        rec["qidx"] = stream.pool_ids(rec["i"])
        if out is None:
            rec["ids"] = None
            return
        st = out["stats"]
        rec["timing"] = out["timing"]
        rec["search_type"] = st.get("search_type")
        rec["stats"] = {key: st[key] for key in
                        ("search_time", "fetch_time", "rounds", "stage_ms", "nodes_visited")
                        if key in st}
        rec["ids"], rec["dists"], rec["texts"] = check.extract(out["results"], k)
        if keep[rec["i"] % keep.size]:
            rec["kept"] = out["results"]

    return consume


def _traced_stretch(engine, call, stream, first: int, n: int, attempts: int = 3) -> dict | None:
    """`n` requests under the profiler (device and host), with the
    harness's spans around each request, the engine's `search_batch` and
    its text join; retried while the profiler dropped kernels."""
    inner = {}
    for attr, label in (("search_batch", "search_batch"), ("_attach_texts_batch", "join")):
        if hasattr(engine, attr):
            fn = getattr(engine, attr)

            def wrapped(*a, _fn=fn, _label=label, **kw):
                with trace.span(_label):
                    return _fn(*a, **kw)

            inner[attr] = wrapped
    for attr, fn in inner.items():
        setattr(engine, attr, fn)
    try:
        st = None
        for _ in range(attempts):
            with trace.profiling(host=True) as prof:
                for i in range(first, first + n):
                    with trace.span("request"):
                        call(stream.texts(i))
                torch.cuda.synchronize()
            st = trace.stretch(*trace.split_events(prof))
            if trace.complete(st):
                return st
        return st if trace.complete(st) else None
    finally:
        for attr in inner:
            delattr(engine, attr)


def _program_stretches(call, stream, first: int, mix: dict, on_card: bool,
                       paired: bool) -> dict | None:
    """The program's own spans and counters from request `first` on: the
    span stretch (`SPAN_REQUESTS` requests, each sent once with tracing
    on; with `paired` also once with it off), then on a card the profiled
    span stretch of `profile_requests` more. None where the program has
    no span recorder."""
    program = program_spans.span_stretch(call, stream, first, SPAN_REQUESTS, paired)
    if program is not None and on_card:
        program["profiled"] = program_spans.profiled_span_stretch(
            call, stream, first + SPAN_REQUESTS, int(mix["profile_requests"]))
    return program


def _refuse_forbidden(log) -> None:
    """Exits with 3, before any result, where the process holds a module
    the benchmark forbids."""
    found = forbidden_modules()
    if found:
        print(f"cudabench: modules loaded that the benchmark forbids: {found}", file=log)
        raise SystemExit(3)


def measure(workload: str, seed: int, seconds: float, traced: bool, *,
            device: str = "cuda", t_process: float | None = None,
            overrides: dict | None = None, traffic_overrides: dict | None = None,
            control: bool = False, span_pairs: bool = False,
            root: pathlib.Path = ROOT, log=sys.stderr) -> tuple[Run, dict]:
    """One run of `workload`; returns what it measured and the result
    line's object. `overrides` and `traffic_overrides` (tests only) replace
    configuration and traffic keys; `control` puts the reference's TF32
    stand-in in the program's place; `span_pairs` (the probe) sends each
    request of the span stretch untraced too, for the tracing's cost."""
    t_process = time.perf_counter() if t_process is None else t_process
    spec = load_spec(root)
    cell = find(spec["workloads"], workload, "workload")
    cfg_entry = find(spec["configs"], cell["config"], "config")
    cfg = {**json.loads((root / cfg_entry["file"]).read_text()), **(overrides or {})}
    check_config(cfg, cfg_entry["file"])
    mix = {**traffic.load(root / "cudabench" / "traffic" / f"{cell['traffic']}.json"),
           **(traffic_overrides or {})}
    metrics = cell_metrics(spec, workload, traced)
    readers = {m["name"]: reader(m["name"], root) for m in metrics}
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)
    run = Run(cell, cfg, mix)
    spans = Spans()
    k, batch = int(cfg["k"]), int(mix["batch"])

    with spans.timed("data"):
        pts_dev, queries_dev = datagen.make_points(cfg, seed, dev)
        pts, queries = pts_dev.cpu().numpy(), queries_dev.cpu().numpy()
    with spans.timed("texts"):
        texts = datagen.make_texts(cfg, seed)
    base = pathlib.Path(tempfile.mkdtemp(prefix="cudabench-"))
    try:
        if control:
            engine = ControlEngine(pts_dev, texts)
        else:
            del pts_dev, queries_dev
            engine = _program(cfg, pts, texts, base, dev, run, spans)
        # the reference's copy of the texts, in an array the garbage
        # collector does not traverse (a 1M-item list would lengthen every
        # full collection in the window)
        texts = _untracked(texts)
        lut = {f"q{j}": queries[j] for j in range(queries.shape[0])}
        l_search = int(mix["l_search"])

        def call(qtexts):
            return engine.search_many(qtexts, k=k, embedding_fn=lut.__getitem__,
                                      l_search=l_search)

        stream = traffic.RequestStream(mix, queries.shape[0], seed)
        with spans.timed("warmup"):
            for i in range(int(mix["warmup_requests"])):
                call(stream.texts(i))
            _sync(dev)
            census0 = gc_census()
        run.setup_s = time.perf_counter() - t_process
        run.setup_spans = dict(spans.items)
        keep = np.random.default_rng([int(seed), 4]).random(4096) < min(1.0, 16.0 / batch)
        first = int(mix["warmup_requests"])
        gcw = run.gc = GcWatch()
        gc.callbacks.append(gcw)
        cpu0 = cpu_seconds()
        try:
            run.requests, run.window_s = traffic.drive(
                call, stream, mix, seconds, first, seed, _consume(stream, k, keep))
        finally:
            gc.callbacks.remove(gcw)
        run.cpu_s = cpu_seconds() - cpu0
        _refuse_forbidden(log)
        peak = 0
        if dev.type == "cuda":
            _sync(dev)
            peak = max([torch.cuda.max_memory_allocated(dev)]
                       + list(run.build_stages.get("peak_device_bytes", {}).values()))
        if traced and dev.type == "cuda":
            run.stretch = _traced_stretch(engine, call, stream, first + len(run.requests),
                                          int(mix["profile_requests"]))
        if traced:
            run.program = _program_stretches(
                call, stream, first + len(run.requests) + int(mix["profile_requests"]), mix,
                dev.type == "cuda", span_pairs)
        del engine
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            if traced and not control:
                run.knn_profile = _profiled_knn_pass(cfg, pts, dev)
        t_ref = time.perf_counter()
        pts_ref = torch.as_tensor(pts, device=dev)
        q_ref = torch.as_tensor(queries, device=dev)
        checks, run.recall = check.evaluate(
            run.requests, pts_ref, q_ref, texts, cfg,
            None if control else cfg["search_type"])
        ref_s = time.perf_counter() - t_ref
    finally:
        shutil.rmtree(base, ignore_errors=True)

    # again after what ran past the window: the stretches, the kNN
    # profile and the reference
    _refuse_forbidden(log)
    print(json.dumps(_summary(run, census0, ref_s, seed, traced, control)), flush=True)
    return run, _result(run, checks, metrics, readers, dev, peak, traced, log)


def _summary(run: Run, census: dict, ref_s: float, seed: int, traced: bool,
             control: bool) -> dict:
    """The line before the result: what the run did, for whoever reads its log."""
    lat = np.array([r["latency_s"] for r in run.requests]) * 1e3
    out = {
        "workload": run.cell["name"], "seed": seed, "trace": int(traced), "control": control,
        "requests": len(run.requests), "queries": int(sum(len(r["qidx"]) for r in run.answered)),
        "median_ms": float(np.median(lat)) if lat.size else None,
        "p95_ms": float(np.percentile(lat, 95)) if lat.size else None,
        "window_s": run.window_s, "setup_s": run.setup_s, "build_s": run.build_s,
        "reference_s": ref_s, "setup_spans": run.setup_spans,
        "build_stages": run.build_stages, "launches": run.launches,
        "knn_profile": run.knn_profile, **card(),
        "gc_in_window": {"count": run.gc.count, "seconds": run.gc.seconds},
        "gc_census": census,
        "cpu_s_in_window": run.cpu_s,
        "window_slices": _slices(run.requests),
        "median_split_ms": {key: float(np.median([_split(r)[key] for r in run.answered]))
                            for key in ("embed", "search", "fetch", "join")}
        if run.answered else None,
        "slowest": [_split(r) for r in sorted(run.answered, key=lambda r: -r["latency_s"])[:5]],
    }
    if run.stretch is not None:
        out["stretch"] = {key: run.stretch[key] for key in
                          ("window_s", "busy_s", "requests", "kernels", "launch_calls")}
    if run.program is not None:
        out["program"] = program_spans.digest(run.program)
    return out


def _result(run: Run, checks: dict, metrics: list, readers: dict, dev: torch.device,
            peak: int, traced: bool, log) -> dict:
    """The result line's object, with the checks last; the checks also
    go to `log`, last."""
    values = {}
    for m in metrics:
        v = readers[m["name"]](run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": all(c["holds"] for c in checks.values()) and bool(run.requests),
            "attempted": len(run.requests),
            "failed": sum(r["error"] is not None for r in run.requests),
            "metrics": values, "device": dev_info}
    if traced and run.stretch is not None:
        dev_info["busy_s"] = run.stretch["busy_s"]
        dev_info["window_s"] = run.stretch["window_s"]
        line["breakdown"] = {"device_ops": run.stretch["device_ops"],
                             "idle_gaps": run.stretch["idle_gaps"]}
    for e in sorted({r["error"] for r in run.requests if r["error"]})[:5]:
        print(f"cudabench: request failed: {e}", file=log)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} {c['op']} {c['limit']!r} "
              f"{'ok' if c['holds'] else 'FAILS'}", file=log)
    log.flush()
    line["checks"] = {name: {"value": c["value"], "limit": c["limit"]} for name, c in checks.items()}
    return line


def _slices(requests: list[dict], parts: int = 5) -> list[dict]:
    """The window cut into `parts` equal stretches by request end: each
    stretch's requests and their median latency in ms."""
    if not requests:
        return []
    t0 = min(r["t_start"] for r in requests)
    end = np.array([r["t_end"] - t0 for r in requests])
    lat = np.array([r["latency_s"] for r in requests]) * 1e3
    part = np.minimum((end / end.max() * parts).astype(int), parts - 1)
    return [{"requests": int((part == j).sum()),
             "median_ms": float(np.median(lat[part == j])) if (part == j).any() else None}
            for j in range(parts)]


def _untracked(items: list) -> np.ndarray:
    arr = np.empty(len(items), object)
    arr[:] = items
    return arr


def _split(rec: dict) -> dict:
    """A request's latency split by the engine's own timing, in ms."""
    t, st = rec["timing"], rec["stats"]
    return {"i": rec["i"], "ms": rec["latency_s"] * 1e3, "embed": t["embedding_time"] * 1e3,
            "search": t["search_time"] * 1e3, "fetch": st.get("fetch_time", 0.0) * 1e3,
            "join": (t["total_time"] - t["search_time"] - t["embedding_time"]) * 1e3,
            "rounds": st.get("rounds"), "stage_ms": st.get("stage_ms")}


def _program(cfg: dict, pts: np.ndarray, texts: list[str], base: pathlib.Path,
             dev: torch.device, run: Run, spans: Spans):
    """The system under test, set up as a user sets it up: the collection
    with its texts, the index build, the engine."""
    from diskrag_tpu_torch.data.collection import CollectionManager
    from diskrag_tpu_torch.engine import SearchEngine

    if dev.type == "cuda":
        with spans.timed("kernels"):
            # the program's kernels and host reader, built (first run in a
            # checkout) or loaded before the build's clock starts
            from diskrag_tpu_torch.kernels import _build as kernel_build
            from diskrag_tpu_torch.native import load_library

            kernel_build.build_all()
            load_library()
    with spans.timed("collection"):
        mgr = CollectionManager(base)
        mgr.create_collection(COLLECTION, int(cfg["dim"]))
        info = mgr.update_collection(COLLECTION, pts, texts,
                                     [datagen.row_metadata(i) for i in range(len(texts))])
        if info.num_vectors != len(texts):
            raise RuntimeError(f"collection holds {info.num_vectors} of {len(texts)} rows")
    _build(cfg, pts, mgr.get_index_dir(COLLECTION), dev, run, spans)
    with spans.timed("engine"):
        engine = SearchEngine(COLLECTION, base_dir=str(base), serving_mode=cfg["serving_mode"],
                              device=str(dev))
    return engine


def main(argv: list[str] | None = None, t_process: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="the reference's TF32 stand-in in the program's place (not a measurement)")
    args = ap.parse_args(argv)
    spec = load_spec()
    cell = find(spec["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"cudabench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    _, line = measure(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_process=t_process, control=args.control)
    print(json.dumps(line), flush=True)
    return 0


def cache_dirs(root: pathlib.Path = ROOT) -> None:
    """Fixed cache directories inside the checkout for what the program
    or PyTorch may compile."""
    cache = root / "cudabench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
