"""The guided traversal: a compressed form of the points steers the graph
search (an exact rerank of beam ∪ visited, where asked, restores the
order). A `Guide` holds one of three forms: plain PQ codes ("pq"),
residual-PQ codes with a cell and a bias a point ("rpq",
`pq/residual.py`) or int-quantized rows ("iq", `pq/intq.py`).

What depends on the form lives here: which one a persisted index carries
(`traversal_mode`, `load_guide`), a batch's tables (`Guide.tables`), the
traversal (`Guide.search`: `beam_search_pq`, B5 by id once a round, or
`beam_search_iq`), the sharded tier's per-shard copies (`Guide.regather`),
the engine's correlation check (`Guide.adc`) and a flush's re-encode
(`Guide.encode_artifacts`). The arrays are device tensors, numpy arrays as
loaded, or `PlacedShards` (`Guide.block`). ADC and iq scores rank by
squared L2 only: callers guide only an L2 traversal.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

import numpy as np
import torch

from diskrag_tpu_torch.graph.search import SearchResult, beam_search_iq, beam_search_pq
from diskrag_tpu_torch.pq.intq import IntQuantizer, IQTables, pad_rows_for_gather
from diskrag_tpu_torch.pq.residual import ResidualPQ, pq_from_arrays

logger = logging.getLogger(__name__)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass(frozen=True)
class GuideTables:
    """A query batch's tables: `main` is the ADC tables [B, m, 256] (a
    residual PQ's inner tables, its cell tables [B, C] in `cells`) or the
    `IQTables`."""

    main: torch.Tensor | IQTables
    cells: torch.Tensor | None = None

    def take(self, rows: slice, device: torch.device) -> "GuideTables":
        """The tables of `rows` of the batch on `device` (the `IQTables`'
        bias affine is the whole batch's)."""
        m = self.main
        if isinstance(m, IQTables):
            m = IQTables(qw=m.qw[rows].to(device), qn=m.qn[rows].to(device),
                         cell_t=None if m.cell_t is None else m.cell_t[rows].to(device),
                         bias_lo=m.bias_lo.to(device), bias_scale=m.bias_scale.to(device))
        else:
            m = m[rows].to(device)
        return GuideTables(m, None if self.cells is None else self.cells[rows].to(device))


@dataclasses.dataclass(frozen=True)
class Guide:
    """A quantizer (`ProductQuantizer`, `ResidualPQ` or `IntQuantizer`) and
    its arrays: `codes` (uint8 [N, m], or int8 rows [N, W]) and, for a
    residual PQ, `cells` (int32 [N]) and `bias` (f32 [N])."""

    pq: Any
    codes: Any
    cells: Any = None
    bias: Any = None
    kind: str = dataclasses.field(init=False)  # "pq" | "rpq" | "iq"

    def __post_init__(self):
        kind = ("iq" if isinstance(self.pq, IntQuantizer)
                else "rpq" if isinstance(self.pq, ResidualPQ) else "pq")
        if kind == "rpq" and (self.cells is None or self.bias is None):
            raise ValueError("residual pq mode needs global pq_cells + pq_bias "
                             "(index/persist.py load_pq_aux)")
        object.__setattr__(self, "kind", kind)

    @property
    def mode(self) -> str:
        """The host tiers' name: "pq" (plain or residual) or "iq"."""
        return "iq" if self.kind == "iq" else "pq"

    @property
    def search_type(self) -> str:
        """The engine's: "pq_accelerated" or "iq_accelerated"."""
        return f"{self.mode}_accelerated"

    def arrays(self) -> tuple:
        """The arrays it holds (what it costs on a device)."""
        return tuple(a for a in (self.codes, self.cells, self.bias) if a is not None)

    def map(self, fn: Callable) -> "Guide":
        """The same quantizer over `fn` of each array."""
        return Guide(self.pq, fn(self.codes), None if self.cells is None else fn(self.cells),
                     None if self.bias is None else fn(self.bias))

    def to(self, device: torch.device) -> "Guide":
        """The arrays on `device` (loaded with their serving dtypes)."""
        return self.map(lambda a: torch.as_tensor(a, device=device))

    def block(self, i: int, j: int) -> "Guide":
        """Shard j of data row i of a guide over `PlacedShards`."""
        return self.map(lambda p: p.blocks[i][j])

    def gather_padded(self) -> "Guide":
        """int rows padded with zero lanes to 256 bytes, which changes no
        score (`pad_rows_for_gather`); PQ codes as they are."""
        if self.kind != "iq":
            return self
        return Guide(self.pq, pad_rows_for_gather(_host(self.codes)))

    def tables(self, queries: torch.Tensor) -> GuideTables:
        """The tables of a query batch [B, D]."""
        if self.kind == "iq":
            return GuideTables(self.pq.query_tables(queries))
        if self.kind == "rpq":
            return GuideTables(self.pq.inner_tables(queries), self.pq.cell_tables(queries))
        return GuideTables(self.pq.compute_distance_tables(queries))

    def search(self, tables: GuideTables, adjacency: torch.Tensor, medoid: torch.Tensor,
               **kw) -> SearchResult:
        """The traversal of a batch from its `tables`. `kw` are what
        `beam_search_pq` and `beam_search_iq` both take: search_width, k,
        max_steps, rerank (with vectors, queries, metric), expand_width,
        entry_points."""
        if self.kind == "iq":
            return beam_search_iq(self.codes, tables.main, adjacency, medoid, dim=self.pq.dim,
                                  bits=self.pq.bits, n_cells=self.pq.n_cells, **kw)
        if self.kind == "rpq":
            kw.update(point_cell=self.cells, point_bias=self.bias, cell_tables=tables.cells)
        return beam_search_pq(self.codes, tables.main, adjacency, medoid, **kw)

    def adc(self, queries: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """[B, len(ids)] approximate squared L2 distances to the points
        `ids`, from the quantizer's own dense lookup."""
        tables = self.pq.compute_distance_tables(queries)
        if self.kind == "rpq":
            return self.pq.asymmetric_distance_sq(tables, self.codes[ids], self.cells[ids])
        return self.pq.asymmetric_distance_sq(tables, self.codes[ids])

    def encode_artifacts(self, vectors) -> dict:
        """`save_index`'s quantizer arguments for `vectors` encoded anew."""
        if self.kind == "rpq":
            codes, cids = self.pq.encode(vectors)
            return {"pq": self.pq, "pq_codes": _host(codes), "pq_coarse_ids": _host(cids)}
        return {"pq": self.pq, "pq_codes": _host(self.pq.encode(vectors))}

    def regather(self, gids: np.ndarray, pad_vectors: Callable[[], np.ndarray]) -> "Guide":
        """Per-shard numpy copies [S, Ns, ...] of the global arrays through
        the global ids gids [S, Ns]. A pad row (id -1) copies a real point:
        it is encoded from its own vector (`pad_vectors()`, the rows of
        `gids < 0` in order), so traversal through it ranks right while its
        id keeps it out of the pool. int rows get the 256-byte gather pad."""
        safe, pad = np.clip(gids, 0, None), gids < 0
        codes = np.asarray(_host(self.codes), np.int8 if self.kind == "iq" else np.uint8)[safe]
        cells = bias = None
        if self.kind == "rpq":
            cells = np.asarray(_host(self.cells), np.int32)[safe]
            bias = np.asarray(_host(self.bias), np.float32)[safe]
        if pad.any():
            enc = self.pq.encode(pad_vectors())
            if self.kind == "rpq":
                codes[pad], cells[pad] = _host(enc[0]), _host(enc[1])
                bias[pad] = _host(self.pq.point_bias(*enc))
            else:
                codes[pad] = _host(enc)
        return Guide(self.pq, codes, cells, bias).gather_padded()


def traversal_mode(store, meta: dict, mode: str | None = None) -> str:
    """A host tier's traversal of a persisted index (`index.persist.
    IndexStore` and meta): `mode` None picks "iq" for int rows, "pq" for
    PQ codes, else "bf16" (always on a non-L2 index); a `mode` asked for
    is checked against the artifacts."""
    metric = meta.get("distance_metric", "l2")
    pq_kind = str(meta.get("pq_kind", "plain"))
    int_rows = pq_kind.startswith("int")
    if mode is None:
        # never auto-pick a traversal that ranks by the wrong metric
        if store.pq_model_path.exists() and metric == "l2":
            return "iq" if int_rows else "pq"
        return "bf16"
    if mode in ("pq", "iq") and metric != "l2":
        raise ValueError(
            f"host-tier {mode} traversal is L2-only (quantized scores "
            f"rank by squared L2); this index uses metric={metric!r} — "
            "serve it in bf16 mode, or normalize the vectors and build "
            "with metric='l2' for angular data"
        )
    if mode == "pq" and int_rows:
        raise ValueError(
            f"host-tier pq traversal cannot score pq_kind={pq_kind!r} "
            "(IntQuantizer rows) — use mode='iq' (or None for auto)"
        )
    if mode == "iq" and not int_rows:
        raise ValueError(
            f"host-tier iq traversal needs IntQuantizer artifacts; "
            f"this index has pq_kind={pq_kind!r} — use mode='pq'"
        )
    if mode not in ("pq", "iq", "bf16"):
        raise ValueError(f"unknown host-tier mode: {mode}")
    return mode


def load_guide(store, *, device, pq=None, codes=None, vectors=None) -> Guide:
    """The guide of a persisted index, its arrays on the host: `pq` and
    `codes` as `load_index` gave them, or read from `store` (the quantizer
    on `device`), and a residual PQ's cells and biases from its aux file.
    An aux missing or stale against the codes is recomputed from `vectors`
    where given (the engine holds them), else raises."""
    from diskrag_tpu_torch.index.persist import load_pq_aux

    if pq is None:
        with np.load(store.pq_model_path) as z:
            pq = pq_from_arrays(dict(z), device=device)
        codes = np.load(store.pq_codes_path)
    if not isinstance(pq, ResidualPQ):
        return Guide(pq, codes)
    try:
        cells, bias = load_pq_aux(store, expect_n=int(codes.shape[0]))
    except ValueError as e:  # stale length: torn
        if vectors is None:
            raise
        logger.warning("%s", e)
        cells = None
    if cells is None:
        if vectors is None:
            raise FileNotFoundError(
                f"residual-PQ host tier needs {store.pq_aux_path} "
                "(written by save_pq_artifacts; rebuild the index)"
            )
        # a torn artifact set: recompute from the resident vectors, cheap,
        # and the serving mode stays available
        logger.warning("recomputing residual-PQ serving arrays from the index vectors")
        cells = pq.coarse_assign(vectors)
        bias = pq.point_bias(codes, cells)
    return Guide(pq, codes, cells, bias)
