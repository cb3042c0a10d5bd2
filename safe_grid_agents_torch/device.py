"""Device resolution with no fallback.

Every entry point of the port runs on ``cuda:0`` unless its caller asks for
the CPU. A missing card is an error, not a silent switch to the CPU: a run
that was meant to measure the card must never measure the host instead.
"""
from __future__ import annotations

import torch

CPU_HINT = "pass device='cpu' (CLI: --platform cpu) to run on the CPU"
# ``--platform`` values of the CLI and the tools, and the device type of each.
PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


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


def platform_device(platform=None) -> torch.device:
    """The device of a ``--platform`` value (``None``: ``cuda:0``), with
    ``resolve_device``'s refusal where no card is visible."""
    if platform is not None and platform not in PLATFORMS:
        raise SystemExit(f"--platform {platform!r}: use one of {sorted(PLATFORMS)}")
    return resolve_device(None if platform is None else PLATFORMS[platform])


def platform_in(argv) -> str | None:
    """The value of the last ``--platform`` flag in a CLI argument list."""
    value = None
    for i, a in enumerate(argv):
        if a == "--platform" and i + 1 < len(argv):
            value = argv[i + 1]
        elif a.startswith("--platform="):
            value = a.split("=", 1)[1]
    return value
