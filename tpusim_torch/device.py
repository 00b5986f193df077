"""Where the port runs: the entry points take `device`, "cuda" by default.

"cuda" launches the hand-written CUDA kernels and needs a card; "cpu" runs
each kernel's plain PyTorch version and must be asked for. Without a card the
default raises instead of running on the CPU unasked.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: tpusim_torch runs its kernels on an "
                "NVIDIA GPU by default; pass device='cpu' to run their plain "
                "PyTorch versions on the CPU")
        return d
    if d.type == "cpu":
        return d
    raise ValueError(f"unsupported device {device!r} (expected cuda or cpu)")
