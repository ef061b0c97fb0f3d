"""Configuration system — behavior parity with the reference's
`preprocessing/config.py`: dataclass config tree, YAML load/save, the
supported-dimension whitelist, sha256 text hashing, and CollectionInfo
with text-hash dedup state.

One deliberate change: the reference's `SUPPORTED_DIMENSIONS` whitelist
{128, 256, 768, 960, 1536} (config.py:87-92) is advisory here, not a
hard gate: ANY dimension is accepted with a warning when outside the
whitelist — the index math is dimension-agnostic on TPU, and the
adaptive-PQ tuner independently falls back to brute force for dims with
no legal subvector split (pq/adaptive.py). Documented deviation.

Copy of `diskrag_tpu/data/config.py` for the PyTorch port, which imports
nothing of the JAX package. PyYAML is imported inside `load_config` / `save_config` only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import pathlib
from typing import Any, Optional

logger = logging.getLogger(__name__)

SUPPORTED_DIMENSIONS = {128, 256, 768, 960, 1536}


def validate_vector_dimension(dimension: int) -> bool:
    """True if the dimension is in the tested whitelist
    (reference config.py:87-92)."""
    return dimension in SUPPORTED_DIMENSIONS


def get_text_hash(text: str) -> str:
    """sha256 of the text — the ingest dedup key (reference config.py:94-96)."""
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


@dataclasses.dataclass
class EmbeddingConfig:
    provider: str = "openai"  # "openai" | "mock" (mock = offline testing)
    model: str = "text-embedding-3-small"
    project_id: Optional[str] = None
    api_key: Optional[str] = None
    max_retries: int = 3
    retry_delay: int = 2
    dimension: Optional[int] = None  # for the mock provider


@dataclasses.dataclass
class QuestionGenerationConfig:
    enabled: bool = True
    provider: str = "openai"
    model: str = "gpt-3.5-turbo"
    max_questions: int = 5
    temperature: float = 0.7
    max_retries: int = 3
    retry_delay: int = 2
    project_id: Optional[str] = None


@dataclasses.dataclass
class ChunkConfig:
    size: int = 300
    overlap: int = 50
    min_size: int = 50


@dataclasses.dataclass
class OutputConfig:
    format: str = "parquet"
    compression: str = "snappy"


@dataclasses.dataclass
class IndexConfig:
    """Index build knobs. The reference *documents* an `index:` block in
    config.yaml but silently ignores it (SURVEY.md §5.6); we honor it."""

    target_quality: str = "balanced"  # fast | balanced | high
    metric: str = "l2"
    type: str = "vamana"  # vamana | flat | ivf | sharded | auto
    force_pq: Optional[bool] = None  # None = adaptive decision
    # quantizer for the PQ-accelerated serving tier: auto (residual on
    # l2, plain otherwise) | plain | residual | int8 | int4 — int8/int4
    # are the MXU-scorable IntQuantizer rows (pq/intq.py): ~10x the
    # traversal QPS of ADC lookups at 2-4x the bytes/point
    pq_kind: str = "auto"
    # explicit graph params override the adaptive schedule when set
    # (the reference documents R/L/alpha in its config.yaml.example
    # index: block but ignores them — we honor them)
    R: Optional[int] = None
    L: Optional[int] = None
    alpha: Optional[float] = None
    build_method: str = "knn"  # knn (MXU kNN-based) | wave (insertion)
    # scan-copy precision for type: flat serving — int8 (per-row scales,
    # default), int8_packed (global scales + packed-int32 fold; fastest,
    # l2/cosine only), or bf16
    flat_precision: str = "int8"
    # candidates kept for the flat scan's exact f32 rerank; None = auto
    # (max(4k, 32)). The post-scan gather is row-latency-bound, so 24
    # trades ~1% recall@10 for ~1.5x QPS at 200k x 128 (see
    # ops/flat_scan_pallas.flat_search_fused).
    flat_rerank_width: Optional[int] = None
    opq_iters: int = 0  # >0 trains an OPQ rotation with the PQ codebooks
    # type: ivf knobs (None = build_ivf defaults). cap_factor bounds the
    # padded cell tiles AND sets the recall ceiling: points that fit
    # none of their 8 nearest cells are displaced where probes never
    # look (see index/ivf.build_ivf). Raise it for recall, at the cost
    # of tile HBM and per-probe scan width.
    ivf_n_cells: Optional[int] = None
    ivf_cap_factor: Optional[float] = None
    # also write the packed record file (index.dat) — required for
    # host_tier serving (f32 vectors host-resident, rerank on host)
    write_compat: bool = False
    # shard count for type: sharded (CLI --shards overrides)
    n_shards: Optional[int] = None


@dataclasses.dataclass
class PreprocessingConfig:
    collection: str
    embedding: EmbeddingConfig = dataclasses.field(default_factory=EmbeddingConfig)
    question_generation: QuestionGenerationConfig = dataclasses.field(
        default_factory=QuestionGenerationConfig
    )
    chunk: ChunkConfig = dataclasses.field(default_factory=ChunkConfig)
    output: OutputConfig = dataclasses.field(default_factory=OutputConfig)
    index: IndexConfig = dataclasses.field(default_factory=IndexConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def load_config(config_path: str | pathlib.Path) -> PreprocessingConfig:
    import yaml

    with open(config_path, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f) or {}
    return PreprocessingConfig(
        collection=data["collection"],
        embedding=EmbeddingConfig(**data.get("embedding", {})),
        question_generation=QuestionGenerationConfig(
            **data.get("question_generation", {})
        ),
        chunk=ChunkConfig(**data.get("chunk", {})),
        output=OutputConfig(**data.get("output", {})),
        index=IndexConfig(**data.get("index", {})),
    )


def save_config(config: PreprocessingConfig, config_path: str | pathlib.Path) -> None:
    import yaml

    with open(config_path, "w", encoding="utf-8") as f:
        yaml.safe_dump(config.to_dict(), f, allow_unicode=True, sort_keys=False)


@dataclasses.dataclass
class CollectionInfo:
    """Per-collection state incl. the sha256 dedup set and text-hash ->
    vector-index map (reference config.py:98-179)."""

    name: str
    config: dict[str, Any]
    dimension: int
    num_vectors: int
    created_at: str
    updated_at: str
    source_files: list[str]
    text_hashes: set[str] = dataclasses.field(default_factory=set)
    vector_offsets: dict[str, int] = dataclasses.field(default_factory=dict)
    chunk_stats: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not validate_vector_dimension(self.dimension):
            # deviation from the reference (which raises): warn only —
            # any dim with a valid PQ split works on TPU
            logger.warning(
                "dimension %d outside the tested whitelist %s",
                self.dimension, sorted(SUPPORTED_DIMENSIONS),
            )

    def add_text(self, text: str, vector_index: int) -> bool:
        """Record a text; False if it was already present (dedup)."""
        h = get_text_hash(text)
        if h in self.text_hashes:
            return False
        self.text_hashes.add(h)
        self.vector_offsets[h] = vector_index
        return True

    def get_vector_index(self, text: str) -> Optional[int]:
        return self.vector_offsets.get(get_text_hash(text))

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "config": self.config,
            "dimension": self.dimension,
            "num_vectors": self.num_vectors,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
            "source_files": self.source_files,
            "text_hashes": sorted(self.text_hashes),
            "vector_offsets": self.vector_offsets,
            "chunk_stats": self.chunk_stats,
        }

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "CollectionInfo":
        data = dict(data)
        data["text_hashes"] = set(data.get("text_hashes", []))
        data["vector_offsets"] = data.get("vector_offsets", {})
        data["chunk_stats"] = data.get("chunk_stats", {})
        return cls(**data)

    @classmethod
    def load(cls, path: pathlib.Path) -> "CollectionInfo":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def save(self, path: pathlib.Path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, ensure_ascii=False, indent=2)
