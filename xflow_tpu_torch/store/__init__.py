"""Hierarchical hot/cold parameter store (the reference's store/
package): ``store_mode='tiered'`` keeps a bounded hot tier of
``2^hot_capacity_log2`` rows per table on the card and the touched
rest on the host, so a table far larger than the card's memory (FM at
T = 2^28) trains.

* ``cold.py`` — the host row store: touched rows packed dense,
  addressed by hashed key, untouched rows materialized lazily from the
  per-row init (a copy of the reference's, numpy only).
* ``hot.py`` — the card's hot tier in one combined buffer per table
  plane with room for a batch's misses, the key→slot map, and the
  tiered step: the port's kernels (K1-K5, K7, K8) over that buffer.
* ``promote.py`` — the asynchronous promotion/demotion worker (a
  thread; its plans are applied between steps).
* ``tiered.py`` — the orchestrator threading the three through
  ``TrainStep.put_batch`` (miss cold-fetch), dispatch (miss
  write-back), checkpoint/export (both tiers folded into one logical
  table) and the ``store`` metrics row.
"""

from xflow_tpu_torch.store.cold import ColdStore, row_init_values
from xflow_tpu_torch.store.hot import HotTier
from xflow_tpu_torch.store.promote import PromotionWorker
from xflow_tpu_torch.store.tiered import BatchPlan, TieredStore

__all__ = [
    "BatchPlan",
    "ColdStore",
    "HotTier",
    "PromotionWorker",
    "TieredStore",
    "row_init_values",
]
