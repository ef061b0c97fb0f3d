"""Embedding generation — counterpart of the reference's
`preprocessing/embedding.py`: provider-backed embeddings with retry +
exponential backoff and a per-text sha256 .npz disk cache.

Providers:
  - "openai": REST call via httpx (the `openai` SDK is not available in
    this environment; same API contract).
  - "mock": deterministic hash-seeded gaussian vectors — the offline
    provider the reference *intended* but never implemented
    (its test uses provider="mock" while `_setup_clients` raises on
    anything but openai — reference embedding.py:57-70,
    scripts/test_faq_workflow.py:27-35; fixed here as SURVEY.md §7.7
    prescribes).

Copy of `diskrag_tpu/data/embedding.py` for the PyTorch port, which imports
nothing of the JAX package. httpx is imported inside the OpenAI call only; the mock provider
gives the JAX package's vectors byte for byte.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import pathlib
import time
from typing import Optional

import numpy as np

from diskrag_tpu_torch.data.config import EmbeddingConfig

logger = logging.getLogger(__name__)

OPENAI_EMBEDDINGS_URL = "https://api.openai.com/v1/embeddings"
DEFAULT_MOCK_DIMENSION = 1536


def mock_embedding(text: str, dimension: int = DEFAULT_MOCK_DIMENSION) -> np.ndarray:
    """Deterministic embedding: md5(text)-seeded normal vector, matching
    the reference test's mock pattern (test_faq_workflow.py:27-35)."""
    seed = int(hashlib.md5(text.encode("utf-8")).hexdigest()[:8], 16)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(dimension).astype(np.float32)
    return v / (np.linalg.norm(v) + 1e-12)


@dataclasses.dataclass
class EmbeddingResult:
    """Single-embedding result record (reference embedding.py:33-37)."""

    vector: np.ndarray
    text: str
    metadata: Optional[dict] = None


class EmbeddingGenerator:
    """Batch embedding with caching and retries."""

    def __init__(
        self,
        config: EmbeddingConfig,
        cache_dir: str | os.PathLike = ".cache/embeddings",
    ):
        self.config = config
        self.provider = config.provider
        if self.provider not in ("openai", "mock"):
            raise ValueError(
                f"unsupported embedding provider: {self.provider!r} "
                "(expected 'openai' or 'mock')"
            )
        self.model = config.model
        self._dimension: Optional[int] = config.dimension
        # the dimension is part of the cache identity: the same
        # provider/model at a different requested dimension (mock, or
        # OpenAI's dimensions parameter) must not serve stale vectors of
        # the old width (deviation from the reference's provider_model
        # key, embedding.py:40-47 — there the dimension is fixed)
        dim_tag = f"_{self._dimension}" if self._dimension else ""
        self.cache_dir = (
            pathlib.Path(cache_dir)
            / f"{self.provider}_{self.model}{dim_tag}".replace("/", "_")
        )
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.cache_hits = 0
        self.cache_misses = 0
        if self.provider == "openai":
            self.api_key = config.api_key or os.environ.get("OPENAI_API_KEY")
            if not self.api_key:
                raise ValueError("OPENAI_API_KEY required for openai provider")

    # --- cache (reference embedding.py:40-98) ----------------------------
    def _cache_path(self, text: str) -> pathlib.Path:
        h = hashlib.sha256(text.encode("utf-8")).hexdigest()
        return self.cache_dir / f"{h}.npz"

    def _cache_get(self, text: str) -> Optional[np.ndarray]:
        path = self._cache_path(text)
        if path.exists():
            try:
                with np.load(path) as z:
                    self.cache_hits += 1
                    return z["embedding"]
            except Exception:  # noqa: BLE001 — corrupt cache entry
                path.unlink(missing_ok=True)
        return None

    def _cache_put(self, text: str, embedding: np.ndarray) -> None:
        try:
            with open(self._cache_path(text), "wb") as f:
                np.savez(f, embedding=embedding)
        except OSError as e:
            logger.warning("embedding cache write failed: %s", e)

    # --- generation ------------------------------------------------------
    def generate(self, text: str) -> np.ndarray:
        """Single-text embedding with cache + retry
        (reference embedding.py:100-148)."""
        cached = self._cache_get(text)
        if cached is not None:
            return cached
        self.cache_misses += 1
        emb = self._generate_uncached([text])[0]
        if emb is None:
            # all retries failed: raise (reference embedding.py:125-127)
            # rather than return-and-cache a None that would surface as
            # an opaque AttributeError far from the cause
            raise RuntimeError(
                f"failed to generate embedding for text: {text[:50]!r}..."
            )
        self._cache_put(text, emb)
        return emb

    def generate_embeddings(
        self, texts: list[str]
    ) -> tuple[np.ndarray, list[int]]:
        """Batch generate; returns (embeddings [V, D], valid_indices) like
        the reference (embedding.py:150-202). Cache-aware: only misses hit
        the provider."""
        results: list[Optional[np.ndarray]] = [None] * len(texts)
        miss_idx = []
        for i, t in enumerate(texts):
            cached = self._cache_get(t)
            if cached is not None:
                results[i] = cached
            else:
                miss_idx.append(i)
        if miss_idx:
            self.cache_misses += len(miss_idx)
            fresh = self._generate_uncached([texts[i] for i in miss_idx])
            for j, i in enumerate(miss_idx):
                if fresh[j] is not None:
                    results[i] = fresh[j]
                    self._cache_put(texts[i], fresh[j])
        valid = [i for i, r in enumerate(results) if r is not None]
        if not valid:
            return np.empty((0, self._dimension or 0), np.float32), []
        embs = np.stack([results[i] for i in valid]).astype(np.float32)
        logger.info(
            "embeddings: %d texts, %d cache hits, %d generated",
            len(texts), len(texts) - len(miss_idx), len(miss_idx),
        )
        return embs, valid

    def _generate_uncached(self, texts: list[str]) -> list[Optional[np.ndarray]]:
        if self.provider == "mock":
            dim = self._dimension or DEFAULT_MOCK_DIMENSION
            self._dimension = dim
            return [mock_embedding(t, dim) for t in texts]
        return self._openai_embeddings(texts)

    def _openai_embeddings(self, texts: list[str]) -> list[Optional[np.ndarray]]:
        import httpx

        out: list[Optional[np.ndarray]] = [None] * len(texts)
        batch = 128
        for start in range(0, len(texts), batch):
            chunk = texts[start : start + batch]
            for attempt in range(self.config.max_retries):
                try:
                    resp = httpx.post(
                        OPENAI_EMBEDDINGS_URL,
                        headers={"Authorization": f"Bearer {self.api_key}"},
                        json={"model": self.model, "input": chunk},
                        timeout=60.0,
                    )
                    resp.raise_for_status()
                    data = resp.json()["data"]
                    for item in data:
                        emb = np.asarray(item["embedding"], np.float32)
                        out[start + item["index"]] = emb
                        self._dimension = emb.shape[0]
                    break
                except Exception as e:  # noqa: BLE001
                    wait = self.config.retry_delay * (2**attempt)
                    logger.warning(
                        "embedding call failed (attempt %d/%d): %s — retry in %ds",
                        attempt + 1, self.config.max_retries, e, wait,
                    )
                    if attempt + 1 < self.config.max_retries:
                        time.sleep(wait)
        return out

    def get_embedding_dimension(self) -> int:
        """Probe the dimension (reference embedding.py:204-209)."""
        if self._dimension is None:
            probe = self.generate("dimension probe")
            self._dimension = int(probe.shape[0])
        return self._dimension
