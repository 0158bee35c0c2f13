"""Device selection: the card unless the caller asks for the CPU.

There is no automatic fallback.  A serving process that silently lands
on the CPU scores correctly but orders of magnitude slower, which shows
up as a latency incident instead of an error at start-up.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``name``; ``"cuda"`` (the default) raises
    RuntimeError when no card is visible.  Only an explicit ``"cpu"``
    runs on the host (the tests do; the wrappers in ops/ then take the
    plain PyTorch versions of the kernels)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is false — pass device='cpu' to run on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (want cuda or cpu)")
    return dev
