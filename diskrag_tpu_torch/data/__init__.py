"""Data pipeline: config, collections, chunking, embeddings, question
generation, ingest orchestration — the counterpart of the reference's
`preprocessing/` package. Host-side Python by design; the TPU never sees
this layer except through the vectors it produces.

Copy of `diskrag_tpu/data/__init__.py` for the PyTorch port, which imports
nothing of the JAX package.
"""

from diskrag_tpu_torch.data.config import (
    ChunkConfig,
    CollectionInfo,
    EmbeddingConfig,
    OutputConfig,
    PreprocessingConfig,
    QuestionGenerationConfig,
    SUPPORTED_DIMENSIONS,
    get_text_hash,
    load_config,
    save_config,
    validate_vector_dimension,
)
from diskrag_tpu_torch.data.collection import CollectionManager
from diskrag_tpu_torch.data.chunker import TextChunker, DocumentProcessor, TextChunk
from diskrag_tpu_torch.data.embedding import EmbeddingGenerator
from diskrag_tpu_torch.data.question_generator import QuestionGenerator
from diskrag_tpu_torch.data.processor import Preprocessor

__all__ = [
    "ChunkConfig",
    "CollectionInfo",
    "CollectionManager",
    "DocumentProcessor",
    "EmbeddingConfig",
    "EmbeddingGenerator",
    "OutputConfig",
    "Preprocessor",
    "PreprocessingConfig",
    "QuestionGenerationConfig",
    "QuestionGenerator",
    "SUPPORTED_DIMENSIONS",
    "TextChunk",
    "TextChunker",
    "get_text_hash",
    "load_config",
    "save_config",
    "validate_vector_dimension",
]
