"""Device resolution with no fallback.

Every entry point of the port runs on ``cuda:0`` unless its caller asks for
the CPU. A missing card is an error, not a silent switch to the CPU: a run
that was meant to measure the card must never measure the host instead.
"""
from __future__ import annotations

import torch

CPU_HINT = "pass device='cpu' (CLI: --platform cpu) to run on the CPU"


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda:0``; raises ``RuntimeError`` if CUDA is asked
    for and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device is visible; {CPU_HINT}")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
