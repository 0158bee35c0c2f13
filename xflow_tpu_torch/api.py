"""Embed-as-a-library API (the reference's api.py::XFlow, on the port).

Construct with paths + config overrides, then train / evaluate /
predict / export / save / restore.  ``device`` places the trainer and
the predict engine: the card unless ``device="cpu"`` is asked for
(device.py::resolve_device).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.trainer import Trainer


class XFlow:
    def __init__(self, train_path: str = "", test_path: str = "",
                 device: str | torch.device = "cuda", **overrides: Any):
        self.config = Config(train_path=train_path, test_path=test_path, **overrides)
        self.trainer = Trainer(self.config, device=device)
        self._engine = None

    def train(self) -> list[dict]:
        return self.trainer.train()

    def evaluate(self, pred_out: str | None = None) -> dict:
        return self.trainer.evaluate(pred_out=pred_out)

    def predict_batch(self, batch) -> np.ndarray:
        """pctr for one Batch built in the raw hash key space (see
        io/batch.py) — the hot-table remap is applied inside.  Routed
        through one PredictEngine over the LIVE trainer state (weights
        always current: ``update_state`` before each call), so batch
        sizes snap onto the engine's shape buckets and its graphs
        (serve/engine.py)."""
        if self.config.store_mode == "tiered":
            raise ValueError(
                "predict_batch over the LIVE trainer state needs the "
                "whole table in device memory, which store_mode="
                "'tiered' deliberately avoids — export_artifact() and "
                "score through PredictEngine.load (the export folds "
                "both tiers into one logical table; docs/STORE.md)"
            )
        if self._engine is None:
            from xflow_tpu_torch.serve.engine import PredictEngine

            self._engine = PredictEngine(
                self.config,
                self.trainer.state,
                device=self.trainer.device,
                remap=self.trainer.remap,
            )
        self._engine.update_state(self.trainer.state)
        return self._engine.predict(batch)

    def export_artifact(self, directory: str) -> str:
        """Freeze the current weights into a serving artifact
        (serve/artifact.py) loadable by PredictEngine with no Trainer,
        loader, or optimizer state."""
        from xflow_tpu_torch.serve.artifact import export_artifact

        return export_artifact(self.trainer, directory)

    def save(self) -> str | None:
        return self.trainer.save()

    def restore(self) -> dict | None:
        return self.trainer.restore()

    def close(self) -> None:
        """Flush/close the trainer's outputs (metrics JSONL)."""
        self.trainer.close()

    def __enter__(self) -> "XFlow":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
