"""xflow-tpu on PyTorch and CUDA: the port of the ``xflow_tpu`` package
to an NVIDIA H100.

The port mirrors the reference package's module paths, so each module
here has its counterpart at the same path there.  It imports ``torch``
and nothing of the reference package: host code it needs is copied, and
the tests hold each copy against its original.

It trains LR, FM and MVM with FTRL or SGD in every update mode from
libffm text or packed shards (trainer.py::Trainer, ``python -m
xflow_tpu_torch.train``) and serves them from exported artifacts
(serve/engine.py::PredictEngine).  Its device work is six hand-written
CUDA kernels: K1 scoring (ops/score.py), K2 the fused train step
(ops/train.py), K3 the optimizer pass (ops/optim.py), K4 and K5 the
touched-rows update (ops/sparse.py) and K6 the dictionary-wire decode
(ops/wire.py), each over a source in csrc/.  Entry points run on the
card unless the caller passes ``device="cpu"`` (device.py).
"""

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.device import resolve_device

__all__ = ["Config", "resolve_device"]
