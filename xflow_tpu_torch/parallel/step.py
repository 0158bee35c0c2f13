"""The reference's parallel/step.py: the host wire, the train step in
every update mode, with and without the hot table, and the device
scoring call, for every model family.

The reference jits ``_train_impl`` (step.py:1024-1129) as one XLA
program.  Here :class:`TrainStep` runs each of its update modes as a
short sequence of hand-written kernels:

* dense (step.py:1070-1129): K2 (ops/train.py: gather, logit, clamped
  sigmoid, residual, per-occurrence gradients scattered into the
  table's [T, D] buffer ``g``, log-loss) over the whole batch, then K3
  (ops/optim.py) once per table over the whole table.  Dense mode with
  ``microbatch > 1`` (the reference's scan over interleaved slices,
  step.py:1085-1121) or ``cold_consolidate`` (``_scatter_grads`` with a
  plan, step.py:984-990) computes this same update: on a TPU those
  forms bound the [B, K, D] intermediates and the scatter's cost, but
  K2 is fused and builds no intermediates, so here they run this step;
* sparse (step.py:1053-1066, ``_sparse_update`` 1158-1248,
  ``_apply_touched_rows`` 1143-1156): K4 (ops/sparse.py: the batch's
  unique keys and each occurrence's slot), K2 in index mode (gradients
  summed per unique key into ``gsum`` [M, D]), and one K5 launch over
  every table (FTRL or SGD on the touched rows only).  The state holds no [T, D]
  gradient buffer;
* sequential (``_train_sequential``, step.py:1250-1325): the batch's
  interleaved slices (``_interleaved_slices``, step.py:264-277: example
  i → slice i % s) in order, each a whole update at its own
  ``num_real`` with the dense inner (K2 + K3) or the sparse inner (K4 +
  K2 + K5), so slice k reads the tables as slice k-1 left them.

The hot table (``hot_size_log2 > 0``; B7): rows [0, H) of each table
are the frequency head (io/freq.py's remap puts the frequent keys
there), and a batch carries a hot plane beside its cold one
(io/batch.py::split_hot).  K1 and K2 read it in the same pass as the
cold plane; its gradients go to an [H, D] destination:

* dense, and the sequential dense inner (step.py:1008-1016): the
  table's own ``g`` (its first H rows), then K3 over the whole table;
* the sparse inner, the hybrid (step.py:1194-1238): K4 over the cold
  keys, K2 with the hot plane's sums in a per-table head buffer, K5
  with the fold (a unique cold key < H adds its sum into the head
  buffer and takes no step), then K3 over rows [0, H) with that buffer
  as ``g``; ``update_mode="sparse"`` with a hot table is refused by
  Config, as the reference's;
* the hot inner (``_train_sequential_hot``, step.py:1327-1497): per
  slice K2 reads the hot plane from the live head and cold keys < H
  from a window-start head snapshot, sums the hot gradients into the
  head buffer, and K3 steps rows [0, H); the cold gradients of every
  slice accumulate in ``g`` (``hot_windowend="dense"``: K3 over the
  whole table closes the window) or, on one K4 plan over the whole
  batch's cold keys, in ``gsum`` (``"sparse"``: K5 closes it).  With
  one slice the reference runs the dense step, and so does the port.

``hot_impl="auto"`` resolves to ``"seg"`` off a TPU, as in the
reference (step.py:333-342), so on the card ``hot_dtype`` matters only
under an explicit ``hot_impl="mxu"``: then, with ``"bfloat16"``, K1 and
K2 round the hot rows and the hot gradients to bfloat16 (ops/hot.py).

A table that opts out of the hot path (``TableSpec.hot=False``: FFM's
v) keeps float32 hot rows and gradients (K1's and K2's FFM form round
w's alone).  The reference gathers such a table's hot rows from rows
[0, H) of the table and scatters their gradients into the full table
(step.py:836-845, 1013-1016), which is what the dense form's first H
rows of ``g`` are.  In the hybrid the reference applies one touched-
rows update to such a table's cold and hot occurrences together
(step.py:1180-1184, 1215-1225); here its hot gradients go to the head
buffer like every table's, K5 folds its cold keys < H in, and K3 steps
rows [0, H).  That gives the same tables: a head row no occurrence
touched has g = 0, and FTRL keeps its z and n and recomputes the same w
from them (init where n == 0), SGD subtracts 0.  The hot inner, which
carries every table's head through its window, is refused for such a
model with the reference's message (step.py:306-320).

``_predict_impl`` (step.py:1516) is :class:`PredictStep`'s one K1
launch (ops/score.py), shared by all.

The tiered store (``store_mode="tiered"``, store/; the reference's
step.py:379-408, 523-563, 609-619): the state's tables are the store's
hot tier, the host resolves each batch's keys through the tier's
key→slot map into refs of a combined row space (hot rows, then the
batch's misses fetched from the host cold store), and ``put_batch``
ships the refs on the compact (or full) wire beside the miss rows; the
update modes above run unchanged over the combined rows
(store/hot.py), ``predict`` the same way, and the miss rows go back to
the host after each dispatch.  The dictionary wire and the staging
ring's split (``put_batch_host`` / ``put_batch_device``) are off there:
they carry raw table keys.

The pooled families (``wide_deep``, ``dcn``, ``two_tower``: models with
``dense_params``, B11) run another kernel pair in every place where
the others run K1 or K2.  Predict: K7 (ops/pool.py ``field_pool``:
the field-pooled tower [B, F, E] and the wide term), the model's
``head`` in torch (cuBLAS on the card), ``sigmoid_ref``.  An update
(the reference's ``grads_from_rows`` autodiff branch, step.py:49-74):
K7, the head under ``torch.autograd`` with the pooled tower as a leaf,
the residual r = (sigmoid(logit) - y) * weight / num_real of the
UNCLAMPED sigmoid (autodiff of ``softplus(logit) - y * logit``; pctr
and the log-loss keep the clamp), ``torch.autograd.grad`` of the logit
with ``grad_outputs=r`` to the tower and the dense parameters, then K8
(``field_pool_grad``) scatters the tower's gradient and x * r into the
same destinations as K2's (``g`` and its first H rows, K4's slots, the
head buffers) and sums the log-loss.  The dense parameters then take
plain SGD at ``sgd_lr`` whatever the table optimizer is
(``apply_dense_sgd``, step.py:90-97), once per update: per dispatch in
dense mode (the reference's microbatch scan sums ``grad_dense`` first,
step.py:1083-1128; the port takes the batch whole), per slice in
sequential mode (step.py:1310) and per slice of the hot inner's
window (step.py:1427), where K7 reads cold keys < H from the
window-start head snapshot.  No step of the head reads a value back to
the host.

State.  ``{"tables": {name: {"param", <aux>..., "g"}}, "dense": {name:
tensor}, "step": int}``: the reference's layout plus ``g``, the table's gradient
buffer, which the port keeps across steps (K3 clears it) where the
reference allocates a zeroed one per step (step.py:1075-1081); the
sparse forms keep none (:func:`uses_grad_buffer`).  The consolidation
buffers (K4's slot map, unique keys and slots, and one ``gsum`` per
table), the head buffers and the head snapshot belong to the
TrainStep, are allocated once at the largest size needed and are left
zeroed (and the map at -1) by K3 and K5.  The reference donates its
state to the jitted step (step.py:402); the port updates these tensors
IN PLACE.

Wires.  The compact wire (hash mode) ships sentinel-coded int32 keys,
``-1`` where the slot is padding, and — for training — uint8 labels and
weights; the hot plane ships as uint16 with ``0xFFFF`` padding when
H <= 2^15, else as int32 with ``-1`` (step.py:225-233,297-300).  The
full wire (numeric mode or ``wire_mode="full"``) ships the same keys
plus the masked values ``x = vals * mask`` (and ``hot_x``) and float32
labels and weights.  A model that reads field ids (``uses_slots``: MVM;
the reference's step.py:296) also gets its field planes, on the card
``fields`` [B, K] and ``hot_fields`` [B, Kh]: uint8 on the compact wire
(``slots_u8``, anything outside [0, 255] clamped to 255, which every
slot consumer ignores since such a model's compact wire needs
``max_fields <= 255``; step.py:174-235), int32 on the full wire (the
raw slots; the only wire when ``max_fields > 255``, step.py:321-327),
and the ``cw_cs``/``cw_hs`` streams on the dictionary wire, which K6
decodes to uint8.  The dictionary wire (``wire_dedup="auto"`` or
``"on"``, hash mode on one device: :func:`dict_wire_ok`) compacts each
batch on the host (io/compact.py::CompactBatch) and ships its tiered
planes, the hot tiers included; K6 (ops/wire.py) decodes them on the
card, in ``put_batch``'s device half, into the compact wire's planes
(the hot plane as int32), so every update mode and ``predict`` run on
the compact wire's planes unchanged.  ``put_batch`` is two halves: the
host half (``put_batch_host``: compaction, the reorder, the copy into
pinned memory and one copy a plane on the step's copy stream), which
the trainer's staging ring runs on worker threads, and the device half
(``put_batch_device``: the step's stream waits on the copies, then
K6), which runs where the step dispatches, so every kernel launches
from one thread on one stream.  ``evaluate``'s batches take the
same wire as training's, as in the reference.  The reference's
dictionary decode also ships a consolidation plan for dense
``cold_consolidate``; the port runs that mode as the plain dense step
(K2 builds no [B, K, D] intermediates), so the plan is not decoded.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.io.batch import Batch, narrow_keys_i32
from xflow_tpu_torch.io.compact import CompactBatch, _clamp_slots_u8
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.obs import Obs
from xflow_tpu_torch.ops.optim import optim_update
from xflow_tpu_torch.ops.pool import field_pool, field_pool_grad
from xflow_tpu_torch.ops.score import score
from xflow_tpu_torch.ops.sparse import consolidate_keys, touched_update
from xflow_tpu_torch.ops.train import train_step
from xflow_tpu_torch.ops.wire import dict_decode, enqueue_planes, pin_planes, to_device
from xflow_tpu_torch.utils.metrics import sigmoid_ref

# {"tables": {name: {"param": [T, D], <aux>, "g"}}, "dense": {name: tensor}, "step": int}
State = dict[str, Any]


def validate_compact_batch(batch: Batch) -> None:
    """Compact-wire invariants: binary features (val 1 wherever mask 1,
    in both sections) and 0/1 labels/weights.  A value-carrying batch on
    the compact wire would silently score with vals=1."""
    if not (
        np.array_equal(batch.vals * batch.mask, batch.mask)
        and np.array_equal(batch.hot_vals * batch.hot_mask, batch.hot_mask)
    ):
        raise ValueError(
            "compact wire requires binary features (val 1 wherever "
            "mask 1); set wire_mode='full' for value-carrying batches"
        )
    for arr in (batch.labels, batch.weights):
        if not np.isin(arr, (0.0, 1.0)).all():
            raise ValueError(
                "compact wire requires 0/1 labels and weights; set "
                "wire_mode='full'"
            )


def sentinel_keys(keys: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """int32 keys with -1 on padding slots.  Narrowed THROUGH the
    audited choke point: masked lanes are zeroed in the wide dtype first
    (padding may carry unreduced garbage, and only live keys owe the
    range contract), then the sentinel is applied in int32 space."""
    live = narrow_keys_i32(np.where(mask > 0, keys, 0))
    return np.where(mask > 0, live, np.int32(-1))


def compact_wire_np(batch: Batch, hot_u16: bool = False,
                    ship_slots: bool = False) -> dict[str, np.ndarray]:
    """The host half of the compact wire (the reference's
    ``compact_wire_np``): sentinel-coded int32 keys + uint8
    labels/weights, a batch's hot plane as uint16 with 0xFFFF padding
    (``hot_u16``: hot ids are < H <= 2^15, so they never reach the
    sentinel) or as sentinel-coded int32, and with ``ship_slots`` the
    uint8 field planes of both sections (anything outside [0, 255]
    clamped to 255, which the models ignore as >= max_fields; a plain
    cast would wrap negatives into the live field range)."""
    out = {
        "ckeys": sentinel_keys(batch.keys, batch.mask),
        "labels_u8": batch.labels.astype(np.uint8),
        "weights_u8": batch.weights.astype(np.uint8),
    }
    if ship_slots:
        out["slots_u8"] = _clamp_slots_u8(batch.slots)
    if batch.hot_nnz:
        if hot_u16:
            out["hot_ckeys_u16"] = np.where(
                batch.hot_mask > 0, batch.hot_keys, 0xFFFF
            ).astype(np.uint16)
        else:
            out["hot_ckeys"] = sentinel_keys(batch.hot_keys, batch.hot_mask)
        if ship_slots:
            out["hot_slots_u8"] = _clamp_slots_u8(batch.hot_slots)
    return out


def full_wire_np(batch: Batch, ship_slots: bool = False) -> dict[str, np.ndarray]:
    """The full wire's planes: sentinel-coded keys, the masked values,
    float32 labels and weights, the hot plane's keys and values, and
    with ``ship_slots`` the int32 field planes, unclamped."""
    out = {
        "ckeys": sentinel_keys(batch.keys, batch.mask),
        "x": (batch.vals * batch.mask).astype(np.float32),
        "labels": batch.labels.astype(np.float32),
        "weights": batch.weights.astype(np.float32),
    }
    if ship_slots:
        out["slots"] = batch.slots.astype(np.int32)
    if batch.hot_nnz:
        out["hot_ckeys"] = sentinel_keys(batch.hot_keys, batch.hot_mask)
        out["hot_x"] = (batch.hot_vals * batch.hot_mask).astype(np.float32)
        if ship_slots:
            out["hot_slots"] = batch.hot_slots.astype(np.int32)
    return out


# host wire plane -> device array: both hot key planes are "hot" on the
# card (uint16 as its int16 view, the bits K1 and K2 read), and the
# field planes of both wires "fields" / "hot_fields"
_DEVICE_NAMES = {"hot_ckeys_u16": "hot", "hot_ckeys": "hot",
                 "slots_u8": "fields", "slots": "fields",
                 "hot_slots_u8": "hot_fields", "hot_slots": "hot_fields"}
PREDICT_PLANES = ("ckeys", "x", "hot", "hot_x", "fields", "hot_fields")


def to_device_planes(wire: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """The compact or full wire's numpy planes as tensors on ``device``
    (ops/wire.py's ``to_device``), under their device names."""
    return {_DEVICE_NAMES.get(k, k): t for k, t in to_device(wire, device).items()}


def hot_impl(cfg: Config) -> str:
    """``Config.hot_impl`` resolved as the reference resolves it
    (step.py:333-342): ``"auto"`` is ``"mxu"`` on a TPU only, so
    ``"seg"`` here."""
    return cfg.hot_impl if cfg.hot_impl != "auto" else "seg"


def hot_bf16(cfg: Config) -> bool:
    """Whether K1 and K2 round the hot plane to bfloat16: the one-hot
    form with ``hot_dtype="bfloat16"`` (ops/hot.py)."""
    return bool(cfg.hot_size) and hot_impl(cfg) == "mxu" and cfg.hot_dtype == "bfloat16"


def hot_windowend(cfg: Config) -> str:
    """``Config.hot_windowend`` resolved as the reference resolves it
    (step.py:343-352): ``"auto"`` is ``"sparse"`` from table_size_log2
    24 on."""
    if cfg.hot_windowend != "auto":
        return cfg.hot_windowend
    return "sparse" if cfg.table_size_log2 >= 24 else "dense"


def hot_window(cfg: Config) -> bool:
    """Whether the hot inner runs its dispatch window (sequential with
    the hot inner and more than one slice); with one slice the
    reference runs the dense step (step.py:1044-1052)."""
    return (cfg.update_mode == "sequential" and cfg.sequential_inner == "hot"
            and cfg.microbatch > 1)


class PredictStep:
    """Wire + device call for one (model, config, device)."""

    def __init__(self, model, cfg: Config, device: torch.device):
        self.model = model
        self.cfg = cfg
        self.device = device
        # Compact wire eligibility (Config.wire_mode): binary vals (hash
        # mode); slot-reading models would also need max_fields <= 255.
        uses_slots = bool(getattr(model, "uses_slots", True))
        compact_ok = cfg.hash_mode and not (uses_slots and cfg.max_fields > 255)
        if cfg.wire_mode == "compact" and not compact_ok:
            raise ValueError(
                "wire_mode='compact' requires hash_mode (binary vals) "
                "and, for slot-reading models, max_fields <= 255; model "
                f"{model.name!r} / hash_mode={cfg.hash_mode} / "
                f"max_fields={cfg.max_fields} does not qualify"
            )
        self.compact_wire = cfg.wire_mode != "full" and compact_ok
        self.ship_slots = uses_slots
        # K1's and K2's form: the family's name (lr, fm, mvm, ffm); the
        # pooled families run K7 and their head instead
        self.form = model.name
        self.pooled = bool(getattr(model, "dense_params", False))
        self.hot_size = cfg.hot_size
        # hot ids fit u16 with the 0xFFFF sentinel only below 2^15 rows
        self.hot_u16 = bool(cfg.hot_size_log2 and cfg.hot_size_log2 <= 15)
        self.hot_bf16 = hot_bf16(cfg)

    def host_wire_np(self, batch: Batch) -> dict[str, np.ndarray]:
        """The numpy planes predict ships for ``batch``."""
        if self.compact_wire:
            wire = compact_wire_np(batch, self.hot_u16, self.ship_slots)
            return {k: a for k, a in wire.items() if k not in ("labels_u8", "weights_u8")}
        wire = full_wire_np(batch, self.ship_slots)
        return {k: a for k, a in wire.items() if k not in ("labels", "weights")}

    def put_batch(self, batch: Batch) -> dict[str, torch.Tensor]:
        """Host->device transfer of the predict wire."""
        return to_device_planes(self.host_wire_np(batch), self.device)

    def predict(self, state: State, arrays: dict[str, torch.Tensor]) -> torch.Tensor:
        """pctr [B] per example (reference calculate_pctr,
        lr_worker.cc:46-61): one K1 launch on the card, the hot plane
        read beside the cold one, and the field planes for MVM; for a
        pooled family K7, the head, the clamp."""
        if self.pooled:
            with torch.no_grad():
                pooled, wide = self.pool(state, arrays)
                return sigmoid_ref(self.model.head(state["dense"], pooled, wide))
        w, v = (param(state["tables"], n) for n in ("w", "v"))
        return score(arrays["ckeys"], arrays.get("x"), w, v,
                     hot=arrays.get("hot"), hot_x=arrays.get("hot_x"),
                     hot_size=self.hot_size, hot_bf16=self.hot_bf16,
                     **self.form_args(arrays))

    def pool(self, state: State, arrays: dict[str, torch.Tensor]):
        """K7 over ``arrays``' planes: (pooled [B, F, E], wide [B] or
        None)."""
        return pool_view(state["tables"], arrays, self.cfg.max_fields, self.hot_size,
                         self.hot_bf16)

    def form_args(self, arrays: dict[str, torch.Tensor]) -> dict:
        """K1's and K2's form and, in the field forms (MVM, FFM), the
        field planes and ``max_fields``."""
        if not self.ship_slots:
            return {"form": self.form}
        return {"form": self.form, "fields": arrays["fields"],
                "hot_fields": arrays.get("hot_fields"), "max_fields": self.cfg.max_fields}


def pool_view(tables: dict, view: dict, max_fields: int, hot_size: int, hot_bf16: bool,
              snaps: dict | None = None):
    """K7 (``field_pool``) over a view's planes and the tables' ``emb``
    and ``w`` (None for two_tower), cold keys < H read from the head
    ``snaps`` when given."""
    snaps = snaps or {}
    return field_pool(view["ckeys"], view.get("x"), view["fields"],
                      tables["emb"]["param"], max_fields, w=param(tables, "w"),
                      hot=view.get("hot"), hot_x=view.get("hot_x"),
                      hot_fields=view.get("hot_fields"), hot_size=hot_size,
                      hot_bf16=hot_bf16, snap_w=snaps.get("w"), snap_emb=snaps.get("emb"))


def param(tables: dict, name: str) -> torch.Tensor | None:
    """Table ``name``'s param, or None where the model has no such
    table (MVM has no ``w``, LR no ``v``)."""
    return tables[name]["param"] if name in tables else None


def table_generator(seed: int, index: int, device: torch.device) -> torch.Generator:
    """The init stream of table ``index``: one generator per table, from
    ``(seed, index)`` (the reference folds the index into its PRNG key,
    step.py:114); index 1000 seeds the dense parameters (step.py:128)."""
    mixed = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, index])
    return torch.Generator(device=device).manual_seed(
        int(mixed.generate_state(1, dtype=np.uint64)[0])
    )


DENSE_STREAM = 1000  # the reference's fold_in(PRNGKey(seed), 1000)


def sparse_update(cfg: Config) -> bool:
    """Whether the optimizer touches only the rows a batch (or slice)
    uses: ``update_mode="sparse"``, or sequential mode's sparse inner."""
    return cfg.update_mode == "sparse" or (
        cfg.update_mode == "sequential" and cfg.sequential_inner == "sparse"
    )


def uses_grad_buffer(cfg: Config) -> bool:
    """Whether a train state keeps the [T, D] gradient buffer ``g``: the
    dense forms do; the sparse update and the hot inner's sparse window
    end allocate none, as the reference allocates none
    (memory-budget.json's ``_train_impl`` entry)."""
    if hot_window(cfg) and hot_windowend(cfg) == "sparse":
        return False
    return not sparse_update(cfg)


def init_state(model, optimizer, cfg: Config, device: torch.device) -> State:
    """Fresh tables on ``device`` (the reference's step.py:100-130): each
    table's init (zeros for w, N(0,1) * v_init_scale for v), the
    optimizer's aux tensors, and a zeroed gradient buffer where the
    update mode uses one."""
    tables: dict[str, dict[str, torch.Tensor]] = {}
    for i, spec in enumerate(model.tables()):
        param = spec.init(
            cfg.table_size, table_generator(cfg.seed, i, device), device
        )
        tables[spec.name] = {"param": param, **optimizer.init_aux(param)}
        if uses_grad_buffer(cfg):
            tables[spec.name]["g"] = torch.zeros_like(param)
    dense = {}
    if hasattr(model, "dense_init"):
        gen = table_generator(cfg.seed, DENSE_STREAM, torch.device("cpu"))
        dense = {k: t.to(device) for k, t in model.dense_init(gen).items()}
    return {"tables": tables, "dense": dense, "step": 0}


def check_servable(cfg: Config) -> None:
    """Refuse a configuration this port cannot serve: an invalid family
    geometry.  A tiered model serves through its folded export
    (serve/artifact.py), which is a dense table."""
    make_model(cfg)


def dict_wire_ok(cfg: Config, uses_slots: bool) -> bool:
    """The reference's dictionary-wire eligibility (step.py:353-366):
    the compact-wire invariants, one device, u8 per-row counts and hot
    ids that fit the tiered encoding.  The port trains on one device:
    ``num_devices`` 0 (all of them) is its one card, and more than one
    is refused (ROADMAP A13)."""
    kh = cfg.hot_nnz if cfg.hot_size else 0
    compact_ok = cfg.hash_mode and not (uses_slots and cfg.max_fields > 255)
    return (
        compact_ok
        and cfg.num_devices <= 1
        and cfg.max_nnz <= 255
        and kh <= 255
        and (not cfg.hot_size_log2 or cfg.hot_size_log2 <= 16)
    )


def check_trainable(cfg: Config) -> None:
    """Refuse a configuration this slice cannot train, naming the
    ROADMAP item that brings it, and ``wire_dedup="on"`` where the
    reference refuses it.  A trained model is evaluated through K1, so
    it must be servable first."""
    check_servable(cfg)
    if cfg.num_devices > 1:
        raise NotImplementedError(
            f"num_devices={cfg.num_devices}: multi-GPU training is not ported "
            "yet (ROADMAP A13)"
        )
    if cfg.wire_dedup == "on" and not dict_wire_ok(cfg, make_model(cfg).uses_slots):
        raise ValueError(
            "wire_dedup='on' requires the compact-wire invariants "
            "(hash_mode; max_fields <= 255 for slot models), a "
            "single-process single-device mesh, max_nnz/hot_nnz "
            "<= 255, and hot_size_log2 <= 16"
        )


class SliceOrdered:
    """A CompactBatch whose rows ``TrainStep.precompact`` already put in
    ``slice_order``: ``put_batch`` ships it without reordering it."""

    __slots__ = ("cb",)

    def __init__(self, cb: CompactBatch):
        self.cb = cb

    def num_real(self) -> int:
        return self.cb.num_real()


@dataclasses.dataclass
class Staged:
    """What ``TrainStep.put_batch_host`` hands to ``put_batch_device``:
    the wire's planes as tensors (on the card, copies in flight on the
    copy stream until ``event``), whether K6 decodes them, and the
    training batch's host floats."""

    decode: bool
    predict: bool
    planes: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    event: Any = None
    num_real: float = 1.0
    slice_num_real: list[float] | None = None


class TrainStep:
    """Wire + device calls for training one (model, optimizer, config,
    device) in the configured update mode (module docstring).
    ``predict`` is PredictStep's K1 call."""

    def __init__(self, model, optimizer, cfg: Config, device: torch.device,
                 obs: Obs | None = None):
        check_trainable(cfg)
        # the hot inner carries every table's head through its window:
        # refused for a model with a table that opts out of the hot path
        # (the reference's check and message, step.py:306-320; legal in
        # the other update modes, where sequential_inner is unused)
        opted_out = [spec.name for spec in model.tables() if not spec.hot]
        if cfg.update_mode == "sequential" and cfg.sequential_inner == "hot" and opted_out:
            raise ValueError(
                "sequential_inner='hot' carries every table's head in "
                f"the scan; model {model.name!r} opts table(s) "
                f"{opted_out} out of the MXU hot path (TableSpec.hot)"
            )
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg
        self.device = device
        self.obs = obs if obs is not None else Obs()
        self.predict_step = PredictStep(model, cfg, device)
        self.compact_wire = self.predict_step.compact_wire
        self.dict_wire = (
            cfg.wire_mode != "full"
            and cfg.wire_dedup != "off"
            and dict_wire_ok(cfg, model.uses_slots)
        )
        self._compact_validated = False
        # sequential slices (Config guarantees that the microbatch
        # divides the batch); the dense forms take the batch whole
        self.slices = cfg.microbatch if cfg.update_mode == "sequential" else 1
        self.sparse = sparse_update(cfg)
        # the hot table: H rows of head, Kh hot slots per row
        self.hot_size = cfg.hot_size
        self.hot_nnz = cfg.hot_nnz if cfg.hot_size else 0
        self.hot_bf16 = hot_bf16(cfg)
        self.window = hot_window(cfg)
        self.windowend = hot_windowend(cfg)
        self.pooled = self.predict_step.pooled
        # FFM's plain dense step takes the batch in `microbatch` row
        # ranges, bounding its [B, K, F*D] and [B, F, F*D] intermediates
        # as the reference's dense microbatch does (ops/train.py); the
        # kernel reads no such argument.  A pooled family takes the view
        # whole on either device.
        self.row_chunks = (cfg.microbatch if cfg.update_mode == "dense"
                           and getattr(model, "autodiff", False) and not self.pooled
                           else 1)
        self._scratch: dict[str, Any] = {}
        # the staging ring's copies run on a stream of their own; every
        # kernel stays on the dispatching thread's stream
        self.copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        # the tiered store (module docstring): the wire carries refs into
        # the combined rows, which the dictionary wire cannot encode
        self.store = None
        if cfg.store_mode == "tiered":
            from xflow_tpu_torch.store.tiered import TieredStore

            self.store = TieredStore(model, optimizer, cfg, device)
            self.store.obs = self.obs
            self.dict_wire = False

    @property
    def wire_format(self) -> str:
        if self.store is not None:
            return "tiered"
        return "dict" if self.dict_wire else "compact" if self.compact_wire else "full"

    def _dict_geometry_ok(self, batch) -> bool:
        """A batch rides the dictionary wire only at the loader's
        geometry; other widths keep the compact wire."""
        return batch.max_nnz == self.cfg.max_nnz and batch.hot_nnz == self.hot_nnz

    def precompact(self, batch):
        """Host dictionary compaction ahead of ``put_batch`` (off the
        consumer thread, for an input fan-out): the CompactBatch
        ``put_batch`` would build, or the batch unchanged where the
        dictionary wire does not apply.  With sequential slices the rows
        go in ``slice_order`` first, as ``put_batch`` puts them, and the
        result is marked :class:`SliceOrdered` so that it is not
        reordered (and compacted) again.  The planes are exactly the
        inline path's."""
        if (isinstance(batch, SliceOrdered) or not self.dict_wire
                or not self._dict_geometry_ok(batch)):
            return batch
        t0 = time.perf_counter()
        if self.slices > 1:
            batch = self._sliced(batch)
        elif isinstance(batch, CompactBatch):
            return batch
        cb = CompactBatch.from_batch(batch, self.cfg.table_size, self.hot_size,
                                     check=not self._compact_validated)
        self._compact_validated = True
        # booked with put_batch_host's compaction (its counter below)
        self.obs.counter("h2d.compact_s", time.perf_counter() - t0)
        return SliceOrdered(cb) if self.slices > 1 else cb

    def host_wire_np(self, batch, predict: bool = False):
        """The numpy planes that cross the link for ``batch`` (a Batch,
        or a CompactBatch from a packed-v2 shard) under this step's
        wire, and the CompactBatch when the dictionary wire ran (else
        None).  ``predict`` ships PredictStep's planes on the other
        wires.  The first batch is validated (the reference's latch:
        loader batches satisfy the invariants by construction)."""
        check = not self._compact_validated
        self._compact_validated = True
        ship = self.predict_step.ship_slots
        if isinstance(batch, CompactBatch):
            if self.dict_wire and self._dict_geometry_ok(batch):
                return batch.wire(ship_slots=ship), batch
            batch = batch.expand()
        if self.dict_wire and self._dict_geometry_ok(batch):
            cb = CompactBatch.from_batch(batch, self.cfg.table_size, self.hot_size,
                                         check=check)
            return cb.wire(ship_slots=ship), cb
        if predict:
            return self.predict_step.host_wire_np(batch), None
        if self.compact_wire:
            if check:
                validate_compact_batch(batch)
            return compact_wire_np(batch, self.predict_step.hot_u16, ship), None
        return full_wire_np(batch, ship), None

    def slice_order(self, b: int) -> np.ndarray:
        """Row order that makes the reference's interleaved slices
        (example i → slice i % s, step.py:264-277) contiguous: slice k is
        rows [k*b/s, (k+1)*b/s) of the reordered planes."""
        s = self.slices
        if b % s:
            raise ValueError(f"microbatch {s} must divide the batch's {b} rows")
        return np.arange(b).reshape(b // s, s).T.reshape(-1)

    def _sliced(self, batch) -> Batch:
        """``batch`` with its rows in ``slice_order``, for the dictionary
        wire to compact: each sequential slice of the decoded planes is
        then a contiguous view."""
        if isinstance(batch, CompactBatch):
            batch = batch.expand()
        order = self.slice_order(batch.batch_size)
        return Batch(keys=batch.keys[order], slots=batch.slots[order],
                     vals=batch.vals[order], mask=batch.mask[order],
                     labels=batch.labels[order], weights=batch.weights[order],
                     hot_keys=batch.hot_keys[order], hot_slots=batch.hot_slots[order],
                     hot_vals=batch.hot_vals[order], hot_mask=batch.hot_mask[order])

    def _book_wire(self, wire: dict[str, np.ndarray], examples: int,
                   cb: CompactBatch | None) -> None:
        """The counters behind the trainer's ``wire`` row (the
        reference's ``_book_wire``): bytes across the link, examples,
        batches, and on the dictionary wire the cold occurrences and the
        table rows they touch after host dedup."""
        self.obs.counter("wire.bytes", sum(int(a.nbytes) for a in wire.values()))
        self.obs.counter("wire.examples", examples)
        self.obs.counter("wire.batches")
        if cb is not None:
            self.obs.counter("wire.cold_occ", cb.n_cold)
            self.obs.counter("wire.cold_touched", cb.cold_touched)

    def put_batch(self, batch, predict: bool = False) -> dict[str, Any]:
        """Host->device transfer of ``batch`` (a Batch, a CompactBatch or
        a :class:`SliceOrdered`) for training or (``predict``) for K1,
        inline: the host half then the device half, both booked as the
        'h2d' phase.  The result holds the compact wire's planes whatever
        the wire (K6 decodes the dictionary wire), and for training
        ``num_real`` = max(sum(weights), 1) as a host float, so the device
        never syncs for it; with sequential slices the rows are in
        ``slice_order`` and ``slice_num_real`` holds each slice's
        max(sum(weights), 1).  Under the tiered store the keys ship as
        refs, and ``miss`` holds the batch's miss rows on the host
        (:meth:`_put_batch_tiered`)."""
        if self.store is not None:
            return self._put_batch_tiered(batch, predict)
        staged = self._put_host(batch, predict)
        with self.obs.phase("h2d"):
            return self.put_batch_device(staged)

    def _put_batch_tiered(self, batch, predict: bool) -> dict[str, Any]:
        """Tiered staging (the reference's ``_put_batch_tiered``): flush
        the previous step's miss write-back (read-your-writes — this
        plan's cold fetch must see it), resolve the keys through the hot
        map, fetch the miss rows from the cold store into host blocks
        (pinned on the card), ship the refs planes, and arm the plan
        until ``train`` pairs it with the step's miss rows."""
        if isinstance(batch, SliceOrdered):
            batch = batch.cb
        if isinstance(batch, CompactBatch):
            batch = batch.expand()
        store = self.store
        with self.obs.phase("h2d"):
            store.complete_pending()
            refs, plan = store.plan_batch(batch, obs=self.obs, param_only=predict)
            self.obs.counter("wire.bytes", plan.miss_nbytes)
        staged = self._put_host(refs, predict)
        with self.obs.phase("h2d"):
            arrays = self.put_batch_device(staged)
        arrays["miss"] = plan.miss_rows
        store.stage(arrays, plan)
        return arrays

    def put_batch_host(self, batch, predict: bool = False) -> Staged:
        """The host half of ``put_batch`` for the staging ring (module
        docstring; refused under the tiered store, whose plans must
        follow the previous step's write-back)."""
        if self.store is not None:
            raise RuntimeError(
                "put_batch_host: the tiered store stages a batch with "
                "put_batch, after the previous step's write-back"
            )
        return self._put_host(batch, predict)

    def _put_host(self, batch, predict: bool = False) -> Staged:
        """The host half of ``put_batch``, safe on a staging-ring worker:
        no device work beyond copies.  It compacts the dictionary wire
        (unless the batch is compacted already), reorders the rows for
        sequential slices, books the wire counters and the 'h2d' phase,
        and takes ``num_real`` and ``slice_num_real``.  On the card it
        copies every plane into pinned host memory and enqueues one
        ``non_blocking`` copy a plane on the step's copy stream, then
        records an event; on the CPU the planes are tensors over the
        numpy arrays.  The split is booked in the ``h2d.compact_s``,
        ``h2d.pin_s`` and ``h2d.enqueue_s`` counters."""
        with self.obs.phase("h2d"):
            t0 = time.perf_counter()
            sliced = self.slices > 1 and not predict
            presliced = isinstance(batch, SliceOrdered)
            if presliced:
                batch = batch.cb
            dict_batch = self.dict_wire and self._dict_geometry_ok(batch)
            if sliced and dict_batch and not presliced:
                batch = self._sliced(batch)
            wire, cb = self.host_wire_np(batch, predict)
            self._book_wire(wire, batch.num_real(), cb)
            weights = batch.weights
            if sliced and not dict_batch:
                order = self.slice_order(len(weights))
                wire = {k: a[order] for k, a in wire.items()}
                weights = weights[order]
            staged = Staged(decode=cb is not None, predict=predict)
            if not predict:
                staged.num_real = max(float(np.sum(weights)), 1.0)
                if self.slices > 1:
                    per = weights.reshape(self.slices, -1).sum(axis=1, dtype=np.float64)
                    staged.slice_num_real = [max(float(w), 1.0) for w in per]
            t1 = time.perf_counter()
            self.obs.counter("h2d.compact_s", t1 - t0)
            if self.device.type == "cuda":
                pinned = pin_planes(wire)
                t2 = time.perf_counter()
                staged.planes, staged.event = enqueue_planes(pinned, self.device,
                                                             self.copy_stream)
                self.obs.counter("h2d.pin_s", t2 - t1)
                self.obs.counter("h2d.enqueue_s", time.perf_counter() - t2)
            else:
                staged.planes = to_device(wire, self.device)
                self.obs.counter("h2d.enqueue_s", time.perf_counter() - t1)
        return staged

    def put_batch_device(self, staged: Staged) -> dict[str, Any]:
        """The device half of ``put_batch``, on the thread that
        dispatches: the current stream waits on the staged copies' event
        (no host sync) and holds each staged tensor for the allocator
        (``record_stream``); on the dictionary wire K6 decodes the
        planes here, on that stream.  Returns ``put_batch``'s dict."""
        planes = staged.planes
        if staged.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.event)
            for t in planes.values():
                t.record_stream(stream)
        if staged.decode:
            decoded = dict_decode(planes, self.cfg.max_nnz, self.hot_nnz)
            # K6's outputs, in order (ops/wire.py dict_decode)
            names = ("ckeys", "labels_u8", "weights_u8") + ("hot",) * bool(self.hot_nnz)
            if "cw_cs" in planes:
                names += ("fields", "hot_fields")[:1 + bool(self.hot_nnz)]
            arrays: dict[str, Any] = dict(zip(names, decoded))
        else:
            arrays = {_DEVICE_NAMES.get(k, k): t for k, t in planes.items()}
        if staged.predict:
            return {k: arrays[k] for k in PREDICT_PLANES if k in arrays}
        arrays["num_real"] = staged.num_real
        if staged.slice_num_real is not None:
            arrays["slice_num_real"] = staged.slice_num_real
        return arrays

    def train(self, state: State, arrays: dict[str, Any]) -> dict[str, torch.Tensor]:
        """One step, in place on ``state``, in the configured update mode
        (module docstring).  Returns ``{"logloss", "count"}`` as device
        tensors (no sync): the log-loss and weight sums over every slice,
        ``logloss = sum / max(count, 1)``.  Under the tiered store the
        update runs over the combined rows (store/hot.py) and the
        step's miss rows are queued for the host."""
        if self.store is not None:
            plan = self.store.take_staged(arrays)
            metrics, writeback = self.store.hot.train(state, arrays, len(plan.miss_keys),
                                                      self._update)
            self.store.defer_complete(plan, writeback)
            return metrics
        tables = state["tables"]
        # float64: every K2 launch of the step adds its block partials here
        acc = torch.zeros(2, dtype=torch.float64, device=self.device)
        if self.window:
            self._train_window(tables, arrays, acc, state["dense"])
        elif self.slices > 1:
            # sequential: each slice is a whole update at its own num_real
            for view, num_real in self._slice_views(arrays):
                self._update(tables, view, num_real, acc, state["dense"])
        else:
            self._update(tables, arrays, arrays["num_real"], acc, state["dense"])
        state["step"] += 1
        return {"logloss": acc[0] / torch.clamp(acc[1], min=1.0), "count": acc[1]}

    def _slice_views(self, arrays: dict[str, Any]):
        """(view, num_real) per sequential slice: rows [k*B/s, (k+1)*B/s)
        of every plane, put_batch having reordered them."""
        rows = arrays["ckeys"].shape[0] // self.slices
        for k, num_real in enumerate(arrays["slice_num_real"]):
            yield {name: a[k * rows:(k + 1) * rows] for name, a in arrays.items()
                   if isinstance(a, torch.Tensor)}, num_real

    def _dense_sgd(self, dense: dict | None, grad_dense: dict | None) -> None:
        """The reference's ``apply_dense_sgd``: p - lr * g, in place."""
        if grad_dense:
            lr = self.cfg.sgd_lr
            for name, p in dense.items():
                p.sub_(lr * grad_dense[name])

    def _update(self, tables: dict, view: dict, num_real: float,
                acc: torch.Tensor, dense: dict | None = None) -> None:
        """One optimizer application over ``view`` (the batch, or one
        sequential slice), every gradient divided by ``num_real``: the
        touched-rows form (K4, K2 in index mode, one K5 over the tables, and with
        a hot plane the hybrid's head step), or the dense form (K2 into
        ``g``, hot gradients into its first H rows, then K3 per
        table); a pooled family runs K7 and K8 where K2 runs, and its
        ``dense`` parameters take one SGD step."""
        if self.sparse:
            grad_dense = self._touched_rows(tables, view, num_real, acc, dense)
        else:
            grads = {n: t["g"] for n, t in tables.items()}
            grad_dense = self._k2(tables, view, num_real, acc, grads,
                                  heads={n: g[:self.hot_size] for n, g in grads.items()},
                                  dense=dense)
            for table in tables.values():
                optim_update(table, self.optimizer)
        self._dense_sgd(dense, grad_dense)

    def _k2(self, tables: dict, view: dict, num_real: float, acc: torch.Tensor,
            grads: dict, slots: torch.Tensor | None = None,
            heads: dict | None = None, snaps: dict | None = None,
            dense: dict | None = None) -> dict | None:
        """One K2 launch over ``view``: cold gradients into ``grads``
        (at ``slots`` in index mode), the hot plane's into ``heads``,
        cold keys < H read from ``snaps`` when given.  A pooled family
        runs :meth:`_pooled_grads` instead and returns the dense
        parameters' gradients."""
        if "labels_u8" in view:
            labels, weights = view["labels_u8"], view["weights_u8"]
        else:
            labels, weights = view["labels"], view["weights"]
        hot = view.get("hot")
        heads = heads if hot is not None else {}
        snaps = snaps or {}
        if self.pooled:
            return self._pooled_grads(tables, view, labels, weights, num_real, acc,
                                      grads, slots, heads, dense, snaps)
        train_step(
            view["ckeys"], view.get("x"), labels, weights, num_real,
            param(tables, "w"), param(tables, "v"),
            grads.get("w"), grads.get("v"), acc, slots=slots,
            hot=hot, hot_x=view.get("hot_x"), hot_size=self.hot_size,
            hot_bf16=self.hot_bf16, hg_w=heads.get("w"), hg_v=heads.get("v"),
            snap_w=snaps.get("w"), snap_v=snaps.get("v"),
            row_chunks=self.row_chunks, **self.predict_step.form_args(view),
        )
        return None

    def _pooled_grads(self, tables: dict, view: dict, labels, weights,
                      num_real: float, acc: torch.Tensor, grads: dict,
                      slots: torch.Tensor | None, heads: dict, dense: dict,
                      snaps: dict) -> dict:
        """A pooled family's forward and backward over ``view`` (module
        docstring): K7, the head under autograd, the unclamped residual,
        K8 into ``grads`` (at ``slots`` in index mode) and ``heads``;
        returns the dense parameters' gradients.  ``snaps`` (the hot
        inner) hold the window-start head K7 reads cold keys < H from."""
        pooled, wide = pool_view(tables, view, self.cfg.max_fields, self.hot_size,
                                 self.hot_bf16, snaps)
        leaf = pooled.requires_grad_(True)
        params = {k: p.detach().requires_grad_(True) for k, p in dense.items()}
        with torch.enable_grad():
            logit = self.model.head(params, leaf, wide)
        with torch.no_grad():
            r = ((torch.sigmoid(logit) - labels.to(torch.float32))
                 * weights.to(torch.float32) / num_real)
        got = torch.autograd.grad(logit, [leaf, *params.values()], grad_outputs=r)
        field_pool_grad(
            view["ckeys"], view.get("x"), view["fields"], got[0].contiguous(), r,
            logit.detach(), labels, weights, self.cfg.max_fields, grads["emb"], acc,
            g_w=grads.get("w"), slots=slots, hot=view.get("hot"), hot_x=view.get("hot_x"),
            hot_fields=view.get("hot_fields"), hot_size=self.hot_size,
            hot_bf16=self.hot_bf16, hg_w=heads.get("w"), hg_emb=heads.get("emb"))
        return dict(zip(params, got[1:]))

    def _touched_rows(self, tables: dict, view: dict, num_real: float,
                      acc: torch.Tensor, dense: dict | None = None) -> dict | None:
        """K4 over the view's cold keys, K2 in index mode into the
        per-table ``gsum``, then one K5 launch over every table: the
        optimizer on the touched rows, and the slot map reset.  With a
        hot plane, the hybrid: K2 sums the hot gradients into the head
        buffers, K5 folds the cold sums of keys < H into them, and K3
        steps rows [0, H)."""
        keys = view["ckeys"]
        scratch = self._buffers(tables, keys.numel())
        m = keys.numel()
        slots = scratch["slots"][:m].view(keys.shape)
        ukeys, count = scratch["ukeys"][:m], scratch["count"]
        rows = table_rows(tables)
        slot_map = self._slot_map(rows)
        consolidate_keys(keys, rows, ukeys, count, slots, slot_map)
        gsum = {n: g[:m] for n, g in scratch["gsum"].items()}
        heads = self._heads(tables) if "hot" in view else None
        grad_dense = self._k2(tables, view, num_real, acc, gsum, slots=slots, heads=heads,
                              dense=dense)
        names = list(tables)
        touched_update([tables[n] for n in names], self.optimizer, ukeys, count,
                       [gsum[n] for n in names], slot_map,
                       head=[heads[n] for n in names] if heads else None,
                       hot_size=self.hot_size)
        if heads:
            for name in names:
                self._head_step(tables[name], heads[name])
        return grad_dense

    def _train_window(self, tables: dict, arrays: dict, acc: torch.Tensor,
                      dense: dict | None = None) -> None:
        """The hot inner's dispatch window (the reference's
        ``_train_sequential_hot``, step.py:1327-1497): ``window_open``,
        ``window_slice`` per slice in order, ``window_close``."""
        window = self.window_open(tables, arrays)
        for k, (view, num_real) in enumerate(self._slice_views(arrays)):
            self.window_slice(tables, window, k, view, num_real, acc, dense)
        self.window_close(tables, window)

    def window_open(self, tables: dict, arrays: dict) -> dict:
        """Open a window over the batch ``arrays``: snapshot the head
        rows the cold plane reads, and (``hot_windowend="sparse"``) K4's
        plan over the whole batch's cold keys, whose ``gsum`` the slices
        fill; returns the window's buffers."""
        if "hot" not in arrays:
            raise ValueError(
                "sequential_inner='hot' needs hot batch planes — was the "
                "loader built with the hot table geometry?"
            )
        h = self.hot_size
        snaps = self._snapshots(tables)
        for name, table in tables.items():
            snaps[name].copy_(table["param"][:h])
        window = {"snaps": snaps, "heads": self._heads(tables),
                  "rows": arrays["ckeys"].shape[0] // self.slices}
        if self.windowend == "sparse":
            keys = arrays["ckeys"]
            m = keys.numel()
            scratch = self._buffers(tables, m)
            window["slots"] = scratch["slots"][:m].view(keys.shape)
            window["ukeys"], window["count"] = scratch["ukeys"][:m], scratch["count"]
            consolidate_keys(keys, self.cfg.table_size, window["ukeys"], window["count"],
                             window["slots"], self._slot_map(self.cfg.table_size))
            window["cold"] = {n: g[:m] for n, g in scratch["gsum"].items()}
        else:
            window["cold"] = {n: t["g"] for n, t in tables.items()}
        return window

    def window_slice(self, tables: dict, window: dict, k: int, view: dict,
                     num_real: float, acc: torch.Tensor, dense: dict | None = None) -> None:
        """Slice ``k`` of the window: K2 (the hot plane on the live head
        into the head buffers, cold keys < H from the snapshot, the cold
        gradients accumulated into the window's buffers; K7 and K8 for a
        pooled family), then K3 over rows [0, H) per table, and the
        dense parameters' SGD step."""
        rows = window["rows"]
        slots = window["slots"][k * rows:(k + 1) * rows] if "slots" in window else None
        grad_dense = self._k2(tables, view, num_real, acc, window["cold"], slots=slots,
                              heads=window["heads"], snaps=window["snaps"], dense=dense)
        for name, table in tables.items():
            self._head_step(table, window["heads"][name])
        self._dense_sgd(dense, grad_dense)

    def window_close(self, tables: dict, window: dict) -> None:
        """Close the window: the cold gradients go in one pass, one K5
        launch over every table on the window's plan, or K3 per table
        over the whole table."""
        if "slots" in window:
            names = list(tables)
            touched_update([tables[n] for n in names], self.optimizer, window["ukeys"],
                           window["count"], [window["cold"][n] for n in names],
                           self._slot_map(self.cfg.table_size))
            return
        for table in tables.values():
            optim_update(table, self.optimizer)

    def _head_step(self, table: dict, head_grad: torch.Tensor) -> None:
        """K3 over rows [0, H) of ``table`` with the head buffer as its
        gradient (views from row 0, so K3's alignment holds); K3 clears
        the buffer."""
        h = self.hot_size
        rows = {k: t[:h] for k, t in table.items() if k != "g"}
        optim_update({**rows, "g": head_grad}, self.optimizer)

    def _heads(self, tables: dict) -> dict[str, torch.Tensor]:
        """The zeroed [H, D] head gradient buffer per table (K3 leaves
        it zeroed)."""
        if "heads" not in self._scratch:
            self._scratch["heads"] = {
                n: torch.zeros((self.hot_size, t["param"].shape[1]), device=self.device)
                for n, t in tables.items()
            }
        return self._scratch["heads"]

    def _snapshots(self, tables: dict) -> dict[str, torch.Tensor]:
        """The [H, D] window-start head snapshot per table (param only)."""
        if "snaps" not in self._scratch:
            self._scratch["snaps"] = {
                n: torch.empty((self.hot_size, t["param"].shape[1]), device=self.device)
                for n, t in tables.items()
            }
        return self._scratch["snaps"]

    def _buffers(self, tables: dict, m: int) -> dict[str, Any]:
        """The consolidation buffers for up to ``m`` occurrences, grown
        (never shrunk) on demand: the zeroed ``gsum`` [M, D] per table,
        K4's unique keys, count and slots, and (on the card) the slot map
        at -1 over the tables' rows (T, or the tiered store's combined
        rows).  K5 leaves ``gsum`` zeroed and the map at -1."""
        sc = self._scratch
        dev = self.device
        if sc.get("cap", 0) < m:
            sc["cap"] = m
            sc["gsum"] = {n: torch.zeros((m, t["param"].shape[1]), device=dev)
                          for n, t in tables.items()}
            sc["ukeys"] = torch.empty(m, dtype=torch.int32, device=dev)
            sc["slots"] = torch.empty(m, dtype=torch.int32, device=dev)
            sc["count"] = torch.zeros(1, dtype=torch.int32, device=dev)
        rows = table_rows(tables)
        if dev.type != "cuda":
            sc["slot_map"] = None  # the plain versions need no map
        elif sc.get("slot_map") is None or sc["slot_map"].numel() < rows:
            sc["slot_map"] = torch.full((rows,), -1, dtype=torch.int32, device=dev)
        return sc

    def _slot_map(self, rows: int) -> torch.Tensor | None:
        """K4's and K5's slot map over the first ``rows`` table rows
        (every entry -1 between launches, so any prefix is a valid map),
        or None on the CPU."""
        sm = self._scratch.get("slot_map")
        return sm[:rows] if sm is not None else None

    def dispatch_train(self, state: State, arrays: dict[str, Any]) -> dict[str, torch.Tensor]:
        """``train`` under the 'dispatch' phase: the launches return as
        soon as they are queued, and the device time surfaces later as
        'device_block' (the epoch-end metrics fetch)."""
        with self.obs.phase("dispatch"):
            return self.train(state, arrays)

    def predict(self, state: State, arrays: dict[str, torch.Tensor]) -> torch.Tensor:
        if self.store is not None:
            return self.store.hot.predict(state, arrays, self.predict_step)
        return self.predict_step.predict(state, arrays)


def table_rows(tables: dict) -> int:
    """Rows of a step's tables: T, or the tiered store's combined view."""
    return next(iter(tables.values()))["param"].shape[0]
