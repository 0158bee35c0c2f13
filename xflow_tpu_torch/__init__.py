"""xflow-tpu on PyTorch and CUDA: the port of the ``xflow_tpu`` package
to an NVIDIA H100.

The port mirrors the reference package's module paths, so each module
here has its counterpart at the same path there.  It imports ``torch``
and nothing of the reference package: host code it needs is copied, and
the tests hold each copy against its original.

This slice serves LR and FM from exported artifacts
(serve/engine.py::PredictEngine).  Its device work is one hand-written
CUDA kernel, ops/score.py + csrc/score.cu.  Entry points run on the card
unless the caller passes ``device="cpu"`` (device.py).
"""

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.device import resolve_device

__all__ = ["Config", "resolve_device"]
