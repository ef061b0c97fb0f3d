"""Text chunking — counterpart of the reference's
`preprocessing/chunker.py`: overlapping char-window chunking with
sentence-boundary snap, FAQ/article CSV handling with auto format
detection, and image/section-aware markdown chunking. Pure host-side
Python (pandas instead of polars).

Copy of `diskrag_tpu/data/chunker.py` for the PyTorch port, which imports
nothing of the JAX package. pandas is imported inside `process_csv` only.
"""

from __future__ import annotations

import dataclasses
import logging
import pathlib
import re
from typing import Any, Literal, Optional

from diskrag_tpu_torch.data.config import ChunkConfig

logger = logging.getLogger(__name__)

SENTENCE_SEPARATORS = [". ", "! ", "? ", "。", "！", "？"]


@dataclasses.dataclass
class TextChunk:
    id: int
    text: str
    source_type: Literal["faq", "article", "document"]
    source_id: str
    section: Optional[str] = None
    metadata: Optional[dict] = None
    image: Optional[str] = None
    manual: Optional[str] = None


@dataclasses.dataclass
class DocumentChunk:
    id: int
    text: str
    image: Optional[str]
    section: str
    manual: str

    @classmethod
    def is_valid_text(cls, text: str, min_length: int = 50, max_length: int = 300) -> bool:
        text = re.sub(r"\s+", " ", text).strip()
        if not min_length <= len(text) <= max_length:
            return False
        if re.match(r"^[\s\W]+$", text):
            return False
        return True


def extract_image_from_text(text: str) -> Optional[str]:
    """First markdown image path in the text, if any."""
    m = re.search(r"!\[.*?\]\((.*?)\)", text)
    return m.group(1) if m else None


def split_text(
    text: str, size: int = 300, overlap: int = 50
) -> list[str]:
    """Overlapping char-window split with sentence-boundary snap
    (reference chunker.py:63-111 behavior)."""
    text = re.sub(r"[\r\n\t]", " ", text)
    text = re.sub(r"\s+", " ", text).strip()
    if len(text) <= size:
        return [text] if text else []
    out = []
    start = 0
    while start < len(text):
        end = min(start + size, len(text))
        chunk = text[start:end]
        if end < len(text):
            for sep in SENTENCE_SEPARATORS:
                pos = chunk.rfind(sep)
                if pos > size // 2:
                    end = start + pos + len(sep)
                    chunk = text[start:end]
                    break
        out.append(chunk.strip())
        if end >= len(text):
            break
        # forward-progress guard: a sentence snap can land end as close
        # as size//2 past start, so overlap >= size//2 (allowed by user
        # config) would move start backward and loop forever
        start = max(end - overlap, start + 1)
    return out


def split_markdown(content: str, source_name: str, config: ChunkConfig) -> list[DocumentChunk]:
    """Section/image-aware markdown chunking
    (reference chunker.py:162-221 behavior).

    Two documented deviations from the reference (both are content-loss
    bugs there, not behavior to keep):
      - an accumulation that outgrows `config.size` is windowed through
        `split_text` instead of blocking emission forever (the reference
        silently drops everything from one long line to EOF);
      - a `# section` heading flushes the pending accumulation into its
        OWN section before switching (the reference merges a section's
        tail into the next section's first chunk, mislabeling it)."""
    chunks: list[DocumentChunk] = []
    current_section = "uncategorized"
    current_text: list[str] = []
    current_image: Optional[str] = None

    def emit(text: str) -> None:
        nonlocal current_image
        chunks.append(
            DocumentChunk(
                id=len(chunks), text=text, image=current_image,
                section=current_section, manual=source_name,
            )
        )
        current_image = None

    def flush(force: bool) -> None:
        nonlocal current_text
        if not current_text:
            return
        text = " ".join(current_text)
        if DocumentChunk.is_valid_text(
            text, min_length=config.min_size, max_length=config.size
        ):
            emit(text)
        elif len(text) > config.size:
            # overlong accumulation (e.g. one paragraph-length line):
            # window it so emission can never block for the rest of the
            # document
            for piece in split_text(text, config.size, config.overlap):
                if len(piece) >= config.min_size:
                    emit(piece)
        elif not force:
            return  # below min_size: keep accumulating
        # force-flush of a sub-min tail drops it (reference behavior)
        current_text = []

    sections = re.split(r"(?=^# )", content, flags=re.MULTILINE)
    for section in sections:
        lines = section.strip().split("\n")
        if not lines:
            continue
        if lines[0].startswith("# "):
            flush(force=True)  # close the previous section's tail
            current_section = lines[0][2:].strip()
            current_image = None
            lines = lines[1:]
        for line in lines:
            img = extract_image_from_text(line)
            if img:
                current_image = img
                continue
            if not line.strip():
                continue
            current_text.append(line)
            flush(force=False)
    flush(force=True)
    return chunks


class TextChunker:
    """Chunker over CSV / markdown inputs."""

    def __init__(self, config: ChunkConfig | None = None):
        self.config = config or ChunkConfig()
        self._current_id = 0

    def _next_id(self) -> int:
        self._current_id += 1
        return self._current_id

    def _split_into_chunks(
        self,
        text: str,
        source_id: str,
        source_type: Literal["faq", "article"],
        section: Optional[str] = None,
        metadata: Optional[dict] = None,
    ) -> list[TextChunk]:
        return [
            TextChunk(
                id=self._next_id(), text=piece, source_type=source_type,
                source_id=source_id, section=section, metadata=metadata,
            )
            for piece in split_text(
                text, size=self.config.size, overlap=self.config.overlap
            )
        ]

    def process_faq_csv(self, df: pd.DataFrame) -> list[TextChunk]:
        """FAQ rows: question/answer (and optional note) joined as one
        chunkable text, question kept in metadata
        (reference chunker.py:113-130 format)."""
        chunks = []
        for _, row in df.iterrows():
            text = f"問題：{row['question']}\n答案：{row['answer_text']}"
            note = row.get("note")
            if isinstance(note, str) and note:
                text += f"\n備註：{note}"
            chunks.extend(
                self._split_into_chunks(
                    text=text,
                    source_id=str(row.get("id", row["question"])),
                    source_type="faq",
                    metadata={"question": row["question"]},
                )
            )
        return chunks

    def process_article_csv(self, df: pd.DataFrame) -> list[TextChunk]:
        chunks = []
        for _, row in df.iterrows():
            chunks.extend(
                self._split_into_chunks(
                    text=row["paragraph_text"],
                    source_id=str(row.get("id", row["title"])),
                    source_type="article",
                    section=row.get("section"),
                    metadata={"title": row["title"]},
                )
            )
        return chunks

    def process_csv(self, file_path: str | pathlib.Path) -> list[TextChunk]:
        """Auto format detection by columns (reference chunker.py:147-160)."""
        import pandas as pd

        df = pd.read_csv(file_path)
        if "question" in df.columns and "answer_text" in df.columns:
            return self.process_faq_csv(df)
        if "title" in df.columns and "paragraph_text" in df.columns:
            return self.process_article_csv(df)
        raise ValueError(
            "Unsupported CSV format. Must be FAQ (question, answer_text) or "
            "Article (title, paragraph_text)."
        )

    def process_markdown(self, file_path: str | pathlib.Path) -> list[DocumentChunk]:
        path = pathlib.Path(file_path)
        content = path.read_text(encoding="utf-8")
        return split_markdown(content, path.name, self.config)


class DocumentProcessor:
    """Collection-aware markdown pipeline
    (reference chunker.py:247-389 role): chunk a markdown file, embed the
    chunks, append to a collection."""

    def __init__(self, chunker: TextChunker, embedding_generator, manager):
        self.chunker = chunker
        self.embedding = embedding_generator
        self.manager = manager

    def process_file(
        self, file_path: str | pathlib.Path, collection_name: str
    ) -> dict[str, Any]:
        path = pathlib.Path(file_path)
        chunks = self.chunker.process_markdown(path)
        if not chunks:
            return {"processed": 0, "skipped": 0}
        texts = [c.text for c in chunks]
        vectors, valid = self.embedding.generate_embeddings(texts)
        if len(valid) == 0:
            return {"processed": 0, "skipped": len(chunks)}
        kept = [chunks[i] for i in valid]
        metadata = [
            {
                "type": "document",
                "section": c.section,
                "manual": c.manual,
                "image": c.image,
            }
            for c in kept
        ]
        info = self.manager.get_collection_info(collection_name)
        if info is None:
            self.manager.create_collection(
                collection_name, vectors.shape[1], source_file=str(path)
            )
        self.manager.update_collection(
            collection_name, vectors, [c.text for c in kept], metadata,
            source_file=str(path),
        )
        return {"processed": len(kept), "skipped": len(chunks) - len(kept)}
