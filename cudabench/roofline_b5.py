"""The least time of B5 by id (`diskrag_tpu_torch/csrc/adc_lookup.cu`,
called through `ops/pq_scan.py::adc_lookup_ids_kernel` once a PQ-guided
traversal round) from the shapes of its calls alone, and its share of
B5's device time in a traced run (`metrics/kernels.b5_roofline.py`).

`chip_smoke.py::b5_ids_bound_ms` counts one call's bytes from its
operands: each id read once (8 bytes) and each output written once (4);
each distinct code row the ids address (m bytes); each table entry those
codes address (the distinct (query, subspace, code) triples, 4 bytes);
with the residual operands each distinct id's cell and bias (8) and each
distinct (query, cell) term (4). A traced run keeps the calls' shapes
only (the program's counters `pq.adc_launches` and `pq.adc_ids`), so
this counts the part of that which the shapes fix: the ids and outputs
in full, and of the rest what every call reads at least: one entry of
each of a query's m tables, one cell term a query, one code row with its
cell and bias. The operations (m adds a pair, 2 more with the residual
terms) are counted in full against the f32 peak. So on the same
operands the bound is never above `b5_ids_bound_ms`'s, and the share
never reads above what the data allow; it reads below the share of that
fuller count by the bytes of the code rows and table entries the data
decide.
"""

from __future__ import annotations

from cudabench import roofline

# the profiler's name of B5's kernel, in every mode (`adc_lookup_kernel<mode, vec>`)
KERNEL = "adc_lookup_kernel"


def b5_ids_bound_ms(launches: int, pairs: int, b: int, m: int,
                    residual: bool) -> tuple[float, str]:
    """Least time of `launches` B5 calls by id that score `pairs` (query,
    candidate) pairs in all, each call over `b` queries' tables of `m`
    subspaces, with or without the residual terms."""
    nbytes = 12 * pairs + launches * (4 * b * m + m + ((8 + 4 * b) if residual else 0))
    t_bytes = nbytes / roofline.PEAK_BYTES
    t_ops = pairs * (m + (2 if residual else 0)) / roofline.PEAK_F32_OPS
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")


def b5_device_ms(stretch: dict | None) -> float | None:
    """Device ms of B5 over the traced stretch's requests, a request, by
    kernel name. The stretch keeps only its ten heaviest device operations
    (`trace.stretch`), so this is None where B5's summed time ranks below
    the tenth; the profiler links B5 to no PyTorch operator, so
    `device_ms_by_span` cannot stand in."""
    if not stretch or not stretch.get("requests"):
        return None
    s = sum(sec for name, sec in stretch["device_ops"] if KERNEL in name)
    return s * 1e3 / stretch["requests"] if s > 0 else None


def share(run) -> float | None:
    """Percent of B5's bound in its device time, each a request: the bound
    from the span stretch's counters over its requests, the device time
    from the harness's traced stretch. None without either, or where the
    program counts no B5 calls."""
    program = run.program or {}
    counters = program.get("counters") or {}
    launches, pairs = counters.get("pq.adc_launches"), counters.get("pq.adc_ids")
    requests = len(program.get("stats") or ())
    device_ms = b5_device_ms(run.stretch)
    if not launches or not pairs or not requests or device_ms is None:
        return None
    bound, _ = b5_ids_bound_ms(launches, pairs, int(run.traffic["batch"]),
                               int(run.config["pq_subvectors"]),
                               run.config.get("traversal_codes") == "rpq")
    return 100.0 * (bound / requests) / device_ms
