"""CLI — counterpart of `diskrag_tpu/cli.py`: the `DiskRAG` facade and
its eight subcommands (`process`, `index` — vamana, flat or auto, with the
config's `index:` block — `search`, `list`, `delete`, `process-dir`,
`merge`, `doctor`), plus `--device {cuda,cpu}` (default cuda), given
before the subcommand.

    python -m diskrag_tpu_torch.cli --config config.yaml process faq.csv -c faq
    python -m diskrag_tpu_torch.cli --config config.yaml index faq
    python -m diskrag_tpu_torch.cli --config config.yaml search faq "question" -k 3 --faq
"""

from __future__ import annotations

import argparse
import logging
import os
import pathlib
import sys
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


def load_dotenv(path: str = ".env") -> None:
    """Manual .env parser (reference diskrag.py:17-30)."""
    env = pathlib.Path(path)
    if not env.exists():
        return
    for line in env.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if line and not line.startswith("#") and "=" in line:
            key, value = line.split("=", 1)
            os.environ.setdefault(key.strip(), value.strip())


class DiskRAG:
    """High-level facade over the pipeline, on one device."""

    def __init__(
        self,
        config_path: str = "config.yaml",
        base_dir: str = "collections",
        device: str = "cuda",
    ):
        from diskrag_tpu_torch.data import (
            CollectionManager,
            PreprocessingConfig,
            load_config,
        )

        load_dotenv()
        self.config_path = config_path
        if pathlib.Path(config_path).exists():
            self.config = load_config(config_path)
        else:
            self.config = PreprocessingConfig(collection="default")
        self.base_dir = base_dir
        self.device = device
        self.manager = CollectionManager(base_dir)

    # --- process ---------------------------------------------------------
    def process(
        self,
        file_path: str,
        collection: Optional[str] = None,
        generate_questions: bool = False,
    ) -> str:
        """Dispatch by file type; returns the resolved collection name
        (CLI arg > config > file stem)."""
        path = pathlib.Path(file_path)
        name = collection or self.config.collection or path.stem
        suffix = path.suffix.lower()
        if suffix == ".csv":
            self._process_csv(path, name, generate_questions)
        elif suffix in (".md", ".markdown"):
            self._process_markdown(path, name)
        else:
            raise ValueError(f"unsupported file type: {suffix}")
        return name

    def _process_csv(self, path: pathlib.Path, name: str, questions: bool) -> None:
        import dataclasses

        import pandas as pd

        from diskrag_tpu_torch.data import EmbeddingGenerator, Preprocessor
        from diskrag_tpu_torch.data.question_generator import QuestionGenerator

        cols = set(pd.read_csv(path, nrows=0).columns)
        if "title" in cols and "paragraph_text" in cols:
            self._process_article_csv(path, name)
            return
        cfg = dataclasses.replace(self.config, collection=name)
        qgen = None
        if questions and cfg.question_generation.enabled:
            qgen = QuestionGenerator(dict(cfg.question_generation.__dict__))
        elif not questions:
            cfg = dataclasses.replace(
                cfg,
                question_generation=dataclasses.replace(
                    cfg.question_generation, enabled=False
                ),
            )
        pre = Preprocessor(
            cfg,
            manager=self.manager,
            embedding_generator=EmbeddingGenerator(cfg.embedding),
            question_generator=qgen,
        )
        pre.process_file(str(path))

    def _process_article_csv(self, path: pathlib.Path, name: str) -> None:
        from diskrag_tpu_torch.data import EmbeddingGenerator, TextChunker

        chunks = TextChunker(self.config.chunk).process_csv(path)
        if not chunks:
            print("(no chunks produced)")
            return
        gen = EmbeddingGenerator(self.config.embedding)
        vectors, valid = gen.generate_embeddings([c.text for c in chunks])
        kept = [chunks[i] for i in valid]
        metas = [
            {
                "type": "article",
                "source_id": c.source_id,
                "section": c.section,
                **(c.metadata or {}),
            }
            for c in kept
        ]
        if self.manager.get_collection_info(name) is None:
            self.manager.create_collection(
                name, vectors.shape[1], config=self.config.to_dict(),
                source_file=str(path),
            )
        self.manager.update_collection(
            name, vectors, [c.text for c in kept], metas, source_file=str(path)
        )

    def _process_markdown(self, path: pathlib.Path, name: str) -> None:
        from diskrag_tpu_torch.data import EmbeddingGenerator, TextChunker
        from diskrag_tpu_torch.data.chunker import DocumentProcessor

        proc = DocumentProcessor(
            TextChunker(self.config.chunk),
            EmbeddingGenerator(self.config.embedding),
            self.manager,
        )
        result = proc.process_file(path, name)
        print(f"processed {result['processed']} chunks ({result['skipped']} skipped)")

    # --- index -----------------------------------------------------------
    def build_index(
        self, collection: str, target_quality: str | None = None,
        force_rebuild: bool = False, index_type: str | None = None,
    ) -> dict:
        from diskrag_tpu_torch.build_index import build_index_from_vectors

        info = self.manager.get_collection_info(collection)
        if info is None:
            raise ValueError(f"collection {collection} not found")
        vectors = np.load(self.manager.get_vectors_path(collection))
        icfg = self.config.index
        override = {
            k: v
            for k, v in (("R", icfg.R), ("L", icfg.L), ("alpha", icfg.alpha))
            if v is not None
        }
        meta = build_index_from_vectors(
            vectors,
            self.manager.get_index_dir(collection),
            # CLI flag wins; otherwise the config.yaml index: block
            target_quality=target_quality or icfg.target_quality,
            metric=icfg.metric,
            force_pq=icfg.force_pq,
            index_type=index_type or icfg.type,
            force_rebuild=force_rebuild,
            build_method=icfg.build_method,
            opq_iters=icfg.opq_iters,
            pq_kind=icfg.pq_kind,
            write_compat=icfg.write_compat,
            params_override=override or None,
            flat_precision=icfg.flat_precision,
            flat_rerank_width=icfg.flat_rerank_width,
            device=self.device,
        )
        info = self.manager.get_collection_info(collection)
        info.chunk_stats["index"] = {
            "index_type": meta.get("index_type", "vamana"),
            "R": meta.get("R"), "L": meta.get("L"), "alpha": meta.get("alpha"),
            "use_pq": meta.get("use_pq"),
            "build_seconds": meta.get("build_seconds"),
        }
        self.manager.save_collection_info(info)
        return meta

    # --- search ----------------------------------------------------------
    def search(
        self, collection: str, query: str, k: int = 5, faq: bool = False,
        serving_mode: str = "auto",
    ) -> dict:
        from diskrag_tpu_torch.data import EmbeddingGenerator
        from diskrag_tpu_torch.engine import SearchEngine

        engine = SearchEngine(collection, base_dir=self.base_dir,
                              serving_mode=serving_mode, device=self.device)
        fn = EmbeddingGenerator(self.config.embedding).generate
        if faq:
            return engine.faq_search(query, k=k, embedding_fn=fn)
        return engine.search(query, k=k, embedding_fn=fn)

    # --- management ------------------------------------------------------
    def list_collections(self):
        return self.manager.list_collections()

    def delete_collection(self, name: str) -> bool:
        return self.manager.delete_collection(name)

    def process_directory(
        self, directory: str, prefix: Optional[str] = None,
        recursive: bool = False, pattern: str = "*",
    ) -> list[str]:
        """Batch process + index every .csv / .md file of a directory,
        one collection per file; returns the collections made. A file that
        fails is logged and the batch goes on."""
        from diskrag_tpu_torch.device import resolve_device

        resolve_device(self.device)  # no card: raise here, not once per file into the log
        root = pathlib.Path(directory)
        files = sorted(root.rglob(pattern) if recursive else root.glob(pattern))
        processed = []
        for f in files:
            if f.suffix.lower() not in (".csv", ".md", ".markdown"):
                continue
            name = f"{prefix}_{f.stem}" if prefix else f.stem
            try:
                self.process(str(f), name)
                self.build_index(name)
                processed.append(name)
            except Exception as e:  # noqa: BLE001 — batch keeps going
                logger.error("failed to process %s: %s", f, e)
        return processed

    def merge_collections(self, sources: list[str], target: str):
        return self.manager.merge_collections(sources, target)

    def doctor(self, collection: str) -> dict:
        """Repair a collection's index artifacts: retrain PQ from
        vectors.npy; if vectors.npy is missing but index artifacts exist,
        reconstruct it from the persisted index. The quantizer kind that
        `meta.json` records is the one retrained; a kind the port cannot
        train yet (int8 / int4) raises `NotImplementedError` rather than
        being repaired as another kind."""
        import json

        from diskrag_tpu_torch.build_index import _resolve_pq_kind, attach_pq
        from diskrag_tpu_torch.device import resolve_device
        from diskrag_tpu_torch.index.persist import IndexStore, load_index, save_index

        resolve_device(self.device)
        report: dict = {"collection": collection, "actions": []}
        vec_path = self.manager.get_vectors_path(collection)
        index_dir = self.manager.get_index_dir(collection)
        store = IndexStore(index_dir)

        if not vec_path.exists() and store.vectors_path.exists():
            vectors = np.load(store.vectors_path)
            with open(vec_path, "wb") as f:
                np.save(f, vectors)
            report["actions"].append("recovered vectors.npy from index")
        if not vec_path.exists():
            report["status"] = "cannot repair: no vectors anywhere"
            return report

        vectors = np.load(vec_path)
        peek: dict = {}
        if store.meta_path.exists():
            try:
                peek = json.loads(store.meta_path.read_text())
            except ValueError:
                pass
        index_type = peek.get("index_type", "vamana")
        if peek.get("pq_kind") in ("int8", "int4"):
            raise NotImplementedError(
                f"doctor: this index was built with pq_kind={peek['pq_kind']!r} (the "
                "int-quantized rows of pq/intq), which the port cannot retrain yet "
                "(ROADMAP.md, 'Modules still to port': int-quantized traversal); "
                "it is not repaired as another kind"
            )
        if index_type in ("flat", "ivf", "sharded"):
            # these types have no detached PQ artifact set to repair
            report["actions"].append(
                f"{index_type} index present — nothing to repair "
                f"(use --force-rebuild to rebuild)"
            )
            report["status"] = "ok"
            return report
        if not store.exists():
            report["actions"].append("no index yet — run `index`")
            report["status"] = "ok"
            return report

        # the index stays on the host: doctor never searches
        index, pq, codes, meta = load_index(index_dir, to_device=False, device=self.device)
        n_index = int(index.vectors.shape[0])
        if len(vectors) != n_index:
            # the collection grew since the build: PQ must be trained on
            # the INDEX's own N rows, or the repaired pq_codes length
            # would mismatch the graph and make the index unloadable
            report["actions"].append(
                f"collection has {len(vectors)} vectors but the index "
                f"was built on {n_index} — repair covers the indexed "
                f"rows; run `index --force-rebuild` to pick up the rest"
            )
        pq_src = index.vectors.cpu().numpy()
        if pq is None or codes is None or len(codes) != n_index:
            # retrain the SAME quantizer kind the index was built with
            # (meta records it); `_resolve_pq_kind` refuses int8 / int4
            kind = _resolve_pq_kind(
                meta.get("pq_kind") or "auto", meta.get("distance_metric", "l2"))
            pq, codes, validation = attach_pq(pq_src, pq_kind=kind, device=self.device)
            if pq is not None:
                coarse = (validation or {}).get("coarse_ids")
                # the fresh PQ's own meta keys must win over the stale ones
                # riding in meta_extra (save_index applies extra last); a
                # non-residual retrain also invalidates pq_aux
                pq_meta_keys = (
                    "use_pq", "n_subvectors", "pq_centroids", "pq_kind",
                    "pq_n_coarse", "iq_row_width", "iq_n_cells",
                )
                if coarse is None:
                    store.pq_aux_path.unlink(missing_ok=True)
                save_index(
                    index_dir, index, pq=pq, pq_codes=codes, pq_coarse_ids=coarse,
                    host_vectors=pq_src,
                    meta_extra={k: v for k, v in meta.items() if k not in pq_meta_keys},
                )
                report["actions"].append(f"retrained PQ (kind={kind})")
        report["status"] = "ok"
        return report


def _print_results(out: dict) -> None:
    """FAQ-aware result printing."""
    results = out.get("results", [])
    if not results:
        print("(no results)")
        return
    for i, r in enumerate(results, 1):
        meta = r.get("metadata", {})
        print(f"\n#{i}  distance={r['distance']:.4f}")
        if meta.get("type") == "faq":
            q = meta.get("original_question") or meta.get("question")
            if q:
                print(f"  Q: {q}")
            a = meta.get("answer")
            if a:
                print(f"  A: {a[:300]}")
            if meta.get("is_generated"):
                print("  (matched via generated question)")
        else:
            print(f"  {r['text'][:300]}")
    timing = out.get("timing", {})
    if timing:
        print(
            f"\nembedding {timing.get('embedding_time', 0)*1e3:.1f}ms | "
            f"search {timing.get('search_time', 0)*1e3:.1f}ms | "
            f"total {timing.get('total_time', 0)*1e3:.1f}ms"
        )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="diskrag-tpu-torch",
        description="DiskRAG on PyTorch/CUDA — Vamana graph and flat-index serving",
    )
    parser.add_argument("--config", default="config.yaml", help="config file path")
    parser.add_argument("--base-dir", default="collections", help="collections dir")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device to build and search on (default cuda)")
    parser.add_argument("--verbose", "-v", action="store_true")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("process", help="process a source file into vectors")
    p.add_argument("file")
    p.add_argument("--collection", "-c")
    p.add_argument("--questions", "-q", action="store_true",
                   help="generate similar questions for FAQ CSVs")

    p = sub.add_parser("index", help="build the index for a collection")
    p.add_argument("collection")
    p.add_argument("--target-quality", choices=["fast", "balanced", "high"],
                   default=None)
    p.add_argument("--index-type", "--type", dest="index_type",
                   choices=["vamana", "flat", "auto"], default=None,
                   help="default: config index.type")
    p.add_argument("--force-rebuild", action="store_true")

    p = sub.add_parser("search", help="search a collection")
    p.add_argument("collection")
    p.add_argument("query")
    p.add_argument("--top-k", "-k", type=int, default=5)
    p.add_argument("--faq", action="store_true",
                   help="FAQ mode: dedup by qa_id, keep type=='faq' entries")
    p.add_argument("--serving-mode", default="auto", choices=["auto"],
                   help="the port serves mode 'auto' (host_tier, sharded_flat "
                        "and streaming are later slices: ROADMAP.md)")

    p = sub.add_parser("process-dir", help="process a whole directory")
    p.add_argument("directory")
    p.add_argument("--prefix", "-p")
    p.add_argument("--recursive", "-r", action="store_true")
    p.add_argument("--pattern", default="*")

    p = sub.add_parser("merge", help="merge collections")
    p.add_argument("collections", nargs="+")
    p.add_argument("--target", "-t", required=True)

    p = sub.add_parser("doctor", help="repair a collection's index artifacts")
    p.add_argument("collection")

    sub.add_parser("list", help="list collections")

    p = sub.add_parser("delete", help="delete a collection")
    p.add_argument("collection")
    return parser


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s",
    )
    rag = DiskRAG(args.config, base_dir=args.base_dir, device=args.device)
    if args.command == "process":
        name = rag.process(args.file, args.collection, args.questions)
        print(f"done — now run: diskrag-tpu-torch index {name}")
    elif args.command == "index":
        meta = rag.build_index(
            args.collection, args.target_quality, args.force_rebuild,
            index_type=args.index_type,
        )
        if meta.get("index_type") == "flat":
            detail = f"precision={meta.get('flat_precision')}"
        else:
            detail = (f"R={meta.get('R', '-')} L={meta.get('L', '-')} "
                      f"use_pq={meta.get('use_pq')} ({meta.get('build_seconds', 0):.1f}s)")
        print(f"index built: type={meta.get('index_type')} N={meta['num_points']} {detail}")
    elif args.command == "search":
        _print_results(rag.search(args.collection, args.query, args.top_k, faq=args.faq,
                                  serving_mode=args.serving_mode))
    elif args.command == "list":
        infos = rag.list_collections()
        if not infos:
            print("(no collections)")
        for info in infos:
            print(
                f"{info.name}: {info.num_vectors} vectors, dim {info.dimension}, "
                f"updated {info.updated_at}"
            )
    elif args.command == "delete":
        print("deleted" if rag.delete_collection(args.collection) else "not found")
    elif args.command == "process-dir":
        names = rag.process_directory(args.directory, args.prefix, args.recursive, args.pattern)
        print(f"processed {len(names)} collections: {', '.join(names)}")
    elif args.command == "merge":
        info = rag.merge_collections(args.collections, args.target)
        print(f"merged into {info.name}: {info.num_vectors} vectors")
    elif args.command == "doctor":
        print(rag.doctor(args.collection))
    return 0


if __name__ == "__main__":
    # die quietly when the reader closes the pipe (e.g. `... | head`)
    try:
        import signal

        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (ImportError, AttributeError, ValueError):
        pass  # no SIGPIPE on this platform
    sys.exit(main())
