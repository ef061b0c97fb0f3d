"""B5's bound from the shapes of its calls (`cudabench/roofline_b5.py`):
never above `chip_smoke.py::b5_ids_bound_ms` on the same operands, equal
to it where the data address the least they can, and the share that
`metrics/kernels.b5_roofline.py` reads from a traced run."""

import importlib.util

import pytest
import torch
from conftest import ROOT

from cudabench import roofline, roofline_b5
from cudabench.harness import Run


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_b5", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(b, c, m, n, cells, seed, same=False):
    g = torch.Generator().manual_seed(seed)
    tables = torch.rand((b, m, 256), generator=g) * 40.0
    code_table = torch.randint(0, 256, (n, m), generator=g, dtype=torch.uint8)
    ids = torch.randint(0, n, (b, c), generator=g)
    if same:  # every pair the same id: the least a call can address
        ids = torch.full((b, c), int(ids[0, 0]))
    aux = {"point_cell": torch.randint(0, cells, (n,), generator=g, dtype=torch.int32),
           "point_bias": torch.rand((n,), generator=g),
           "cell_tables": torch.rand((b, cells), generator=g)}
    return tables, code_table, ids, aux


# (B, C, m, rows, cells): the cell's round (B 512, E 4 x R 32, m 50, 2048
# cells) over a table cut to 20,000 rows, ragged and tiny calls
SHAPES = [(512, 128, 50, 20_000, 2048), (64, 64, 50, 4000, 64), (37, 5, 8, 300, 16),
          (1, 48, 64, 1000, 32), (3, 1, 1, 10, 2)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("residual", [True, False])
def test_never_above_chip_smokes_bound_on_seeded_operands(shape, residual):
    cs = _chip_smoke()
    b, c, m, n, cells = shape
    for seed, same in ((1, False), (2, False), (3, True)):
        tables, code_table, ids, aux = _operands(b, c, m, n, cells, seed, same)
        aux = aux if residual else {}
        full, _ = cs.b5_ids_bound_ms(tables, code_table, ids, aux)
        ours, by = roofline_b5.b5_ids_bound_ms(1, b * c, b, m, residual)
        assert ours <= full, (shape, seed)
        if same:
            assert ours == pytest.approx(full, rel=1e-12), shape
    assert roofline.PEAK_F32_OPS == cs.PEAK_F32_OPS
    assert roofline.PEAK_BYTES == cs.PEAK_BYTES


def test_calls_add_up():
    one = roofline_b5.b5_ids_bound_ms(1, 512 * 128, 512, 50, True)[0]
    assert roofline_b5.b5_ids_bound_ms(20, 20 * 512 * 128, 512, 50, True)[0] == \
        pytest.approx(20 * one)
    assert roofline_b5.b5_ids_bound_ms(1, 512 * 128, 512, 50, True)[1] == "bytes"


def test_the_kernel_name_is_b5s():
    src = (ROOT / "diskrag_tpu_torch" / "csrc" / "adc_lookup.cu").read_text()
    assert f"void __launch_bounds__(kThreads) {roofline_b5.KERNEL}(" in src


def _run(counters=None, device_ops=None, requests=2, span_requests=4):
    run = Run({"name": "x"}, {"pq_subvectors": 50, "traversal_codes": "rpq"}, {"batch": 512})
    if counters is not None:
        run.program = {"counters": counters, "stats": [{}] * span_requests}
    if device_ops is not None:
        run.stretch = {"requests": requests, "device_ops": device_ops}
    return run


def test_share_reads_a_request_of_each_side():
    launches, pairs = 4 * 20, 4 * 20 * 512 * 128  # 4 requests of 20 rounds
    bound = roofline_b5.b5_ids_bound_ms(launches, pairs, 512, 50, True)[0] / 4
    ops = [["void (anonymous namespace)::adc_lookup_kernel<2, 1>(Operands)", 2 * bound * 1e-3 * 5],
           ["void at::native::vectorized_elementwise_kernel<...>", 1.0]]
    run = _run({"pq.adc_launches": launches, "pq.adc_ids": pairs}, ops)
    assert roofline_b5.share(run) == pytest.approx(20.0)


def test_share_is_none_without_b5_or_its_counters():
    counters = {"pq.adc_launches": 80, "pq.adc_ids": 80 * 512 * 128}
    b5 = [["adc_lookup_kernel<2, 1>", 1e-3]]
    assert roofline_b5.share(_run()) is None
    assert roofline_b5.share(_run(counters, [["other_kernel", 1.0]])) is None
    assert roofline_b5.share(_run({}, b5)) is None  # a program without the counters
    assert roofline_b5.share(_run(counters)) is None  # no traced stretch (the CPU)
    assert roofline_b5.share(_run(counters, b5)) > 0


def test_tables_and_rerank_read_device_ms_a_request_of_their_spans():
    """`pq.tables_ms` and `graph.rerank_ms.pq`: the device time of the
    kernels launched inside their spans over the profiled span stretch's
    requests; nothing where the program has no such span (the parent) or
    no profile ran (the CPU)."""
    from cudabench import harness

    run = Run({"name": "x"}, {}, {})
    run.program = {"records": [], "counters": {},
                   "profiled": {"stretch": {"requests": 8},
                                "device_ms_by_span": {"engine.pq_tables": 1.08,
                                                      "graph.rerank": 4.02, "graph.seed": 41.6}}}
    assert harness.reader("pq.tables_ms")(run) == pytest.approx(1.08 / 8)
    assert harness.reader("graph.rerank_ms.pq")(run) == pytest.approx(4.02 / 8)
    run.program["profiled"]["device_ms_by_span"] = {"graph.seed": 41.6}
    untraced = Run({"name": "x"}, {}, {})
    cpu = Run({"name": "x"}, {}, {})
    cpu.program = {"records": [], "counters": {}}
    for name in ("pq.tables_ms", "graph.rerank_ms.pq"):
        for r in (run, untraced, cpu):
            assert harness.reader(name)(r) is None, name
