"""xflow-tpu on PyTorch and CUDA: the port of the ``xflow_tpu`` package
to an NVIDIA H100.

The port mirrors the reference package's module paths, so each module
here has its counterpart at the same path there.  It imports ``torch``
and nothing of the reference package: host code it needs is copied, and
the tests hold each copy against its original.

It trains every family the reference has, with FTRL or SGD in every
update mode, from libffm text or packed shards (trainer.py::Trainer,
``python -m xflow_tpu_torch.train``), and serves them from exported
artifacts (serve/engine.py::PredictEngine, one CUDA graph per bucket)
through the reference's production tier: the replica fleet, the score
cache, the HTTP and XFB1 front ends, the open-loop load generator and
the retrieval→ranking cascade (``python -m xflow_tpu_torch.serve``);
``XFlow`` (api.py) wraps training and scoring as a library.  Its device
work is eight hand-written CUDA kernels: K1 scoring (ops/score.py), K2
the fused train step (ops/train.py), K3 the optimizer pass
(ops/optim.py), K4 and K5 the touched-rows update (ops/sparse.py), K6
the dictionary-wire decode (ops/wire.py) and K7/K8 the pooled families'
field pooling and its backward (ops/pool.py), each over a source in
csrc/.  Entry points run on the card unless the caller passes
``device="cpu"`` (device.py).
"""

from xflow_tpu_torch.api import XFlow
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.device import resolve_device

__all__ = ["Config", "XFlow", "resolve_device"]
