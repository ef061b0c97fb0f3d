"""Device resolution for every entry point of the port.

Every public entry point takes an explicit `device`, default "cuda".
When no CUDA card is visible and the caller did not ask for "cpu", it
raises: the port never drops to the CPU on its own, because a search
that silently ran on the CPU would report the CPU's speed under the
card's name.

Float32 matrix products are pinned to full float32. PyTorch's default
for `torch.backends.cuda.matmul.allow_tf32` is already False, but
cuDNN's is True, and TF32 keeps only ~10 mantissa bits: the exact f32
rerank (`ops.distance.rerank_exact_topk`) and the ground-truth oracle
must not lose digits to it, so both switches are set here, where the
package is imported.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """The torch.device an entry point runs on. "cuda" (or "cuda:N")
    needs a visible card and raises without one; "cpu" must be asked for
    by name (the tests do)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is visible; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
