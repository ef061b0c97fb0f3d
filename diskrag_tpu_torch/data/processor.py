"""FAQ ingest orchestration — counterpart of the reference's
`preprocessing/processor.py`: read a FAQ CSV (question/answer columns),
normalize CJK punctuation, build per-row nested FAQ metadata (qa_id,
is_generated, original_question), optionally augment with LLM-generated
similar questions, embed everything, and append to the collection with
sha256 dedup.

Copy of `diskrag_tpu/data/processor.py` for the PyTorch port, which imports
nothing of the JAX package. pandas is imported inside the functions that read or write CSVs.
"""

from __future__ import annotations

import json
import logging
import pathlib
from typing import Any, Optional

import numpy as np
from diskrag_tpu_torch.data.collection import CollectionManager
from diskrag_tpu_torch.data.config import PreprocessingConfig, get_text_hash
from diskrag_tpu_torch.data.embedding import EmbeddingGenerator
from diskrag_tpu_torch.data.question_generator import QuestionGenerator

logger = logging.getLogger(__name__)

# CJK punctuation normalization map (reference processor.py:213-245)
_CHAR_MAP = {
    "：": ":", "？": "?", "！": "!", "（": "(", "）": ")",
    "【": "[", "】": "]", "「": '"', "」": '"', "『": "'", "』": "'",
    "、": ",", "；": ";", "，": ",", "。": ".",
}


def normalize_text(text: str) -> str:
    for cn, en in _CHAR_MAP.items():
        text = text.replace(cn, en)
    return text


class Preprocessor:
    """FAQ CSV -> collection pipeline."""

    def __init__(
        self,
        config: PreprocessingConfig,
        manager: CollectionManager | None = None,
        embedding_generator: EmbeddingGenerator | None = None,
        question_generator: QuestionGenerator | None = None,
        base_dir: str = "collections",
    ):
        self.config = config
        self.manager = manager or CollectionManager(base_dir)
        self.embedding = embedding_generator or EmbeddingGenerator(config.embedding)
        self.question_generator = question_generator
        if self.question_generator is None and config.question_generation.enabled:
            try:
                self.question_generator = QuestionGenerator(
                    {
                        **config.question_generation.__dict__,
                    }
                )
            except ValueError as e:
                logger.warning("question generation disabled: %s", e)
                self.question_generator = None

    def process_file(
        self, input_file: str, dry_run: bool = False
    ) -> Optional[dict[str, Any]]:
        """Process a FAQ CSV into the configured collection
        (reference processor.py:308-508 flow).

        `dry_run` follows the reference's semantics (processor.py:313:
        "generate questions only, no vectors/index"): question
        generation STILL runs (paid LLM calls) and the `*_post.csv`
        companion file is still written; only the embedding + collection
        update are skipped."""
        path = pathlib.Path(input_file)
        if path.suffix.lower() != ".csv":
            raise ValueError(f"FAQ processor only supports CSV, got {path.suffix}")
        import pandas as pd

        df = pd.read_csv(path)
        logger.info("read %d rows from %s (columns: %s)", len(df), path, list(df.columns))
        missing = [c for c in ("question", "answer") if c not in df.columns]
        if missing:
            raise ValueError(f"CSV missing required columns: {', '.join(missing)}")

        all_texts: list[str] = []
        all_metadata: list[dict] = []
        generated_rows: list[dict] = []

        for i, row in df.iterrows():
            q = row.get("question")
            a = row.get("answer")
            if not isinstance(q, str) or not isinstance(a, str) or not q or not a:
                logger.warning("skipping row %d: missing question/answer", i + 1)
                continue
            qa_id = row.get("id")
            if not isinstance(qa_id, str) or not qa_id:
                qa_id = get_text_hash(q + a)
            nq = normalize_text(q)
            na = normalize_text(a)
            shared = {
                "qa_id": qa_id,
                "answer": na,
                "source_file": _opt(row, "source_file"),
                "source_page": _opt(row, "source_page"),
                "source_section": _opt(row, "source_section"),
                "source_image": _opt(row, "source_image"),
            }
            all_texts.append(nq)
            all_metadata.append(
                _faq_metadata(shared, nq, nq, is_generated=False, qa_id=qa_id)
            )

            if self.question_generator is not None:
                try:
                    gen = self.question_generator.generate_similar_questions(
                        original_question=nq, answer=na,
                        source_type="faq", source_id=qa_id, metadata=shared,
                    )
                except Exception as e:  # noqa: BLE001 — augmentation is best-effort
                    logger.warning("question generation failed (row %d): %s", i + 1, e)
                    gen = []
                for g in gen:
                    all_texts.append(g.question)
                    all_metadata.append(
                        _faq_metadata(shared, g.question, nq, is_generated=True,
                                      qa_id=qa_id)
                    )
                    generated_rows.append(
                        {"id": qa_id, "question": g.question, "answer": na,
                         "is_generated": True}
                    )

        if not all_texts:
            logger.warning("no valid FAQ pairs in %s", input_file)
            return None

        if generated_rows:
            self._save_generated_questions(path, generated_rows)

        if dry_run:
            logger.info("dry run: prepared %d texts, stopping before embed", len(all_texts))
            return {"texts": len(all_texts), "dry_run": True}

        vectors, valid = self.embedding.generate_embeddings(all_texts)
        if not valid:
            raise RuntimeError("embedding generation produced no vectors")
        texts = [all_texts[i] for i in valid]
        metas = [all_metadata[i] for i in valid]

        name = self.config.collection
        info = self.manager.get_collection_info(name)
        if info is None:
            self.manager.create_collection(
                name, vectors.shape[1],
                config=self.config.to_dict(), source_file=str(path),
            )
        self.manager.update_collection(
            name, vectors, texts, metas, source_file=str(path)
        )
        return {
            "collection": name,
            "texts": len(texts),
            "generated": len(generated_rows),
        }

    def _save_generated_questions(
        self, source_path: pathlib.Path, rows: list[dict]
    ) -> None:
        """Persist generated questions next to the source as *_post.csv
        (reference processor.py:33-160)."""
        out = source_path.with_name(source_path.stem + "_post.csv")
        import pandas as pd

        pd.DataFrame(rows).to_csv(out, index=False)
        logger.info("saved %d generated questions -> %s", len(rows), out)


def _opt(row, key):
    v = row.get(key)
    if v is None or (isinstance(v, (float, np.floating)) and np.isnan(v)):
        return None
    if isinstance(v, np.generic):
        # pandas hands back np.int64/np.float64/np.bool_ for numeric
        # CSV columns — json.dumps on the metadata dict rejects those
        v = v.item()
    return v


def _faq_metadata(
    shared: dict, text: str, original_question: str, *, is_generated: bool,
    qa_id: str,
) -> dict:
    """Row metadata with the nested JSON `metadata` field the reference
    writes (processor.py:367-423) and the search layer unwraps."""
    meta = dict(shared)
    meta.update(
        {
            "is_generated": is_generated,
            "original_question": original_question,
            "text": text,
            "text_hash": get_text_hash(text),
            "metadata": json.dumps(
                {
                    "type": "faq",
                    "is_generated": is_generated,
                    "original_question": original_question,
                    "qa_id": qa_id,
                },
                ensure_ascii=False,
            ),
        }
    )
    return meta
