"""Serving: artifacts, the bucketed PredictEngine (one CUDA graph per
bucket on the card), the MicroBatcher, the hot-key ScoreCache, the
ReplicaFleet with admission control and staged rollout, the HTTP
(ServeTier) and XFB1 (BinaryTier) front ends, the open-loop load
generator, the retrieval→ranking CascadeEngine and the
``serve``/``cascade``/``loadgen``/``score``/``bench``/``index`` CLI
(``python -m xflow_tpu_torch.serve``)."""
