"""Serving: artifacts, the bucketed PredictEngine, the MicroBatcher and
the ``score``/``bench`` CLI (``python -m xflow_tpu_torch.serve``)."""
