"""Environment report (counterpart of
`diskrag_tpu/tools/verify_installation.py`): JSON report of python,
packages, torch and CUDA, the card, `nvcc`, and whether the port's CUDA
kernels build and load.

    python -m diskrag_tpu_torch.tools.verify_installation [--device cpu]

On the card (the default) a missing card raises, and a kernel that does
not build raises too: the report is for a machine that is meant to serve.
With `--device cpu` the CUDA parts are reported as not checked.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

from diskrag_tpu_torch.device import resolve_device


def verify_installation(device: str = "cuda") -> dict:
    import torch

    import diskrag_tpu_torch
    from diskrag_tpu_torch.kernels import _build

    dev = resolve_device(device)
    report: dict = {
        "python": sys.version.split()[0],
        "packages": {},
        "diskrag_tpu_torch": diskrag_tpu_torch.__version__,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": None, "count": 0},
        "nvcc": "not checked",
        "kernels": "not checked",
        "openai_api_key": bool(os.environ.get("OPENAI_API_KEY")),
    }
    for mod in ("torch", "numpy", "pandas", "pyarrow", "yaml", "pydantic", "httpx", "aiohttp"):
        try:
            m = importlib.import_module(mod)
            report["packages"][mod] = getattr(m, "__version__", "ok")
        except ImportError:
            report["packages"][mod] = None
    if dev.type == "cuda":
        report["device"].update(kind=torch.cuda.get_device_name(dev),
                                count=torch.cuda.device_count())
        report["nvcc"] = _build._nvcc()
        paths = _build.build_all()
        for stem in paths:
            _build.load(stem)
        report["kernels"] = {stem: str(path) for stem, path in sorted(paths.items())}
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="diskrag_tpu_torch environment report")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(verify_installation(args.device), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
