"""K2, the fused sparse train step: wrapper, plain version and binding.

``train_step(keys, x, labels, weights, num_real, w, v, g_w, g_v, acc)``
runs one dense-mode forward/backward for LR (``v`` None) or FM over
sentinel-coded keys [B, K] and ACCUMULATES into its outputs: the
residual-scaled per-occurrence gradients are scatter-added into ``g_w``
[T, 1] and ``g_v`` [T, D], and ``acc`` float64 [2] (csrc/train.cu says
why) gains the batch's log-loss sum and weight sum.  ``x`` None means x = 1 on live slots (the compact
wire); ``labels``/``weights`` are uint8 (compact wire) or float32 (full
wire); ``num_real`` is the host float max(sum(weights), 1).

Index mode (``slots`` given, the sparse update modes): ``slots`` int32 [B, K] is K4's slot plane
(ops/sparse.py ``consolidate_keys``), -1 on padding, and occurrence
(b, k)'s gradient lands in row ``slots[b, k]`` of ``g_w`` [M, 1] and
``g_v`` [M, D] (M >= B*K, the per-unique-key sums) instead of row
``keys[b, k]`` of a [T, D] buffer.  The forward, residual and log-loss
are the same.

The hot plane (B7): ``hot`` [B, Kh] (int16 = u16 bits with 0xFFFF
padding, or int32 with -1), ``hot_x``, ``hot_size`` and ``hot_bf16`` as
K1 takes them (ops/score.py), hot entries first.  A hot occurrence's
gradient lands in row ``key`` of ``hg_w`` [H, 1] / ``hg_v`` [H, D]: the
first H rows of ``g_w``/``g_v`` in dense mode, a per-table head buffer
in the hybrid and the hot inner.  Window-start mode (``snap_w``/
``snap_v`` [H, D], the hot inner): cold keys < H read the window-start
head snapshot instead of the live table.

On CUDA tensors it launches the hand-written kernel in csrc/train.cu
(which names the JAX regions it replaces and states its bound); on CPU
tensors it runs :func:`train_plain`, the literal PyTorch transcription
of the reference's ``_expand_wire`` → gather → ``logit`` →
``sigmoid_ref`` → residual → ``grad_logit`` → drop-mode scatter-add →
``logloss_sum``.  There is no fallback: a CUDA tensor launches the
kernel or raises.

``train_step.launches`` counts kernel launches (never plain-version
calls).
"""

from __future__ import annotations

import ctypes

import torch

from xflow_tpu_torch.models.fm import FMModel
from xflow_tpu_torch.models.lr import LRModel
from xflow_tpu_torch.ops.hot import hot_scatter
from xflow_tpu_torch.ops.score import check_hot, plain_view
from xflow_tpu_torch.utils.metrics import logloss_sum, sigmoid_ref

# the kernel's register-resident D capacity (csrc/train.cu kMaxDim)
MAX_DIM = 32
_I32_MAX = 2**31 - 1

_bound: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        from xflow_tpu_torch.ops.build import load_library

        lib = load_library("train")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.xf_train_step.argtypes = [
            vp, vp, vp, vp, ci, cf, vp, vp, vp, vp, vp, vp, ci, ci, ci,
            vp, vp, ci, ci, ci, ci,  # hot, hot_x, hot_u16, H, bf16, KH
            vp, vp, vp, vp,  # hg_w, hg_v, snap_w, snap_v
            vp,
        ]
        lib.xf_train_step.restype = ci
        lib.xf_train_max_dim.argtypes = []
        lib.xf_train_max_dim.restype = ci
        if lib.xf_train_max_dim() != MAX_DIM:
            raise RuntimeError(
                f"csrc/train.cu kMaxDim {lib.xf_train_max_dim()} != "
                f"ops/train.py MAX_DIM {MAX_DIM}"
            )
        _bound = lib
    return _bound


def _check(keys, x, labels, weights, w, v, g_w, g_v, acc, slots) -> None:
    if keys.dtype != torch.int32 or keys.dim() != 2:
        raise ValueError(f"keys must be int32 [B, K], got {keys.dtype} {tuple(keys.shape)}")
    b = keys.shape[0]
    if w.dtype != torch.float32 or w.dim() != 2 or w.shape[1] != 1:
        raise ValueError(f"w must be float32 [T, 1], got {w.dtype} {tuple(w.shape)}")
    if w.shape[0] > _I32_MAX:
        raise ValueError(f"table of {w.shape[0]} rows does not fit int32 keys")
    if labels.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"labels must be uint8 or float32, got {labels.dtype}")
    if labels.shape != (b,) or weights.shape != (b,) or weights.dtype != labels.dtype:
        raise ValueError(
            f"labels/weights must be [{b}] of one dtype, got "
            f"{labels.dtype} {tuple(labels.shape)} / {weights.dtype} "
            f"{tuple(weights.shape)}"
        )
    # the gradient buffers' rows: T (dense mode) or the slots' M >= B*K
    rows = w.shape[0] if slots is None else max(keys.numel(), 1)
    if (g_w.dtype != torch.float32 or g_w.dim() != 2 or g_w.shape[1] != 1
            or (g_w.shape[0] != rows if slots is None else g_w.shape[0] < rows)):
        raise ValueError(
            f"g_w must be float32 [{rows}, 1] (dense) or [>= B*K, 1] (index "
            f"mode), got {g_w.dtype} {tuple(g_w.shape)}"
        )
    if acc.shape != (2,) or acc.dtype != torch.float64:
        raise ValueError("acc must be float64 [2]")
    tensors = [("keys", keys), ("labels", labels), ("weights", weights),
               ("w", w), ("g_w", g_w), ("acc", acc)]
    if slots is not None:
        if slots.dtype != torch.int32 or slots.shape != keys.shape:
            raise ValueError(
                f"slots must be int32 {tuple(keys.shape)}, got {slots.dtype} "
                f"{tuple(slots.shape)}"
            )
        tensors.append(("slots", slots))
    if x is not None:
        if x.dtype != torch.float32 or x.shape != keys.shape:
            raise ValueError(
                f"x must be float32 {tuple(keys.shape)}, got {x.dtype} {tuple(x.shape)}"
            )
        tensors.append(("x", x))
    if (v is None) != (g_v is None):
        raise ValueError("v and g_v come together (FM) or not at all (LR)")
    if v is not None:
        if v.dtype != torch.float32 or v.dim() != 2 or v.shape[0] != w.shape[0]:
            raise ValueError(
                f"v must be float32 [{w.shape[0]}, D], got {v.dtype} {tuple(v.shape)}"
            )
        if not 1 <= v.shape[1] <= MAX_DIM:
            raise ValueError(f"v width {v.shape[1]} outside [1, {MAX_DIM}]")
        if g_v.dtype != torch.float32 or g_v.shape != (g_w.shape[0], v.shape[1]):
            raise ValueError(
                f"g_v must be float32 {(g_w.shape[0], v.shape[1])}, got "
                f"{g_v.dtype} {tuple(g_v.shape)}"
            )
        tensors += [("v", v), ("g_v", g_v)]
    for name, t in tensors:
        if t.device != keys.device:
            raise ValueError(f"{name} on {t.device}, keys on {keys.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_head(keys, hot, hot_x, hot_size, w, v, hg_w, hg_v, snap_w, snap_v) -> None:
    """The hot plane, its [H, D] gradient destination and the window-
    start snapshot: each [H, dim] float32 and contiguous, beside w/v."""
    if hot is None and (hg_w is not None or hg_v is not None):
        raise ValueError("hg_w/hg_v need a hot plane")
    if hot is None and snap_w is None:
        return
    if not 0 < hot_size <= w.shape[0]:
        raise ValueError(f"hot_size {hot_size} outside (0, {w.shape[0]}]")
    heads = []
    if hot is not None:
        check_hot(keys, hot, hot_x, hot_size, w)
        heads += [("hg_w", hg_w, w), ("hg_v", hg_v, v)]
    if snap_w is not None:
        heads += [("snap_w", snap_w, w), ("snap_v", snap_v, v)]
    for name, t, table in heads:
        if (t is None) != (table is None):
            raise ValueError(f"{name} must come with its table, and only then")
        if t is None:
            continue
        if t.dtype != torch.float32 or t.shape != (hot_size, table.shape[1]):
            raise ValueError(
                f"{name} must be float32 {(hot_size, table.shape[1])}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.device != keys.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {keys.device}")


def occurrence_grads(keys, x, labels, weights, num_real, w, v, hot=None,
                     hot_x=None, hot_size=0, hot_bf16=False, snap_w=None,
                     snap_v=None):
    """The plain forward and backward up to the scatter: the forward's
    plain half (ops/score.py ``plain_view``: the wire decoded, cold rows
    gathered — from the window-start head at keys < H when given — and
    the hot rows through ``hot_gather``), the model's logit and explicit
    gradient times the residual.  Returns (the per-occurrence gradients
    {"w", "v"} [B, Kh + K, dim], hot slots first and not yet rounded to
    bfloat16, the hot keys [B, Kh] or None, pctr, the model's batch
    view)."""
    rows, batch, hk = plain_view(keys, x, w, v, hot, hot_x, hot_size,
                                 hot_bf16, snap_w, snap_v)
    batch["labels"] = labels.to(torch.float32)
    batch["weights"] = weights.to(torch.float32)
    model = LRModel() if v is None else FMModel(v_dim=v.shape[1])
    pctr = sigmoid_ref(model.logit(rows, batch))
    residual = (pctr - batch["labels"]) * batch["weights"] / num_real
    occ = {name: g * residual[:, None, None]
           for name, g in model.grad_logit(rows, batch).items()}
    return occ, hk, pctr, batch


def train_plain(keys, x, labels, weights, num_real, w, v, g_w, g_v, acc,
                slots=None, hot=None, hot_x=None, hot_size=0, hot_bf16=False,
                hg_w=None, hg_v=None, snap_w=None, snap_v=None) -> None:
    """K2's plain PyTorch version, step for step the reference's
    ``_train_impl`` up to the optimizer: ``occurrence_grads``, the
    scatter-add of live cold occurrences (at ``slots`` in index mode),
    ``hot_scatter`` of the hot ones into ``hg_w``/``hg_v``, and the
    log-loss sum."""
    occs, hk, pctr, batch = occurrence_grads(keys, x, labels, weights, num_real,
                                             w, v, hot, hot_x, hot_size, hot_bf16,
                                             snap_w, snap_v)
    # The reference drops padding occurrences (sentinel key T, mode=
    # "drop", step.py:923).  Their x is 0, so their gradients are
    # exactly +-0 and adding them at the clamped row 0 leaves every
    # value as dropping would — without the host sync that selecting
    # the live occurrences would cost.
    kh = 0 if hk is None else hk.shape[1]
    cold = torch.clamp(keys, min=0).long() if slots is None else torch.clamp(slots, min=0).long()
    flat_keys = cold.reshape(-1)
    gbufs = {"w": g_w, "v": g_v}
    hbufs = {"w": hg_w, "v": hg_v}
    impl, dtype = ("mxu", torch.bfloat16) if hot_bf16 else ("seg", torch.float32)
    for name, occ in occs.items():
        d = occ.shape[-1]
        # cold first, then the hot sums, as the reference's
        # _scatter_grads orders them (step.py:1000-1016)
        gbufs[name].index_add_(0, flat_keys, occ[:, kh:].reshape(-1, d))
        if kh:
            # masked hot slots carry H, dropped (the reference's
            # _hot_keys_eff, step.py:1131-1141)
            hot_keys_eff = torch.where(hk >= 0, hk, torch.full_like(hk, hot_size))
            hbufs[name] += hot_scatter(hot_keys_eff.reshape(-1), occ[:, :kh].reshape(-1, d),
                                       hot_size, dtype=dtype, impl=impl)
    acc[0] += logloss_sum(batch["labels"], pctr, batch["weights"])
    acc[1] += torch.sum(batch["weights"])


def train_step(keys, x, labels, weights, num_real, w, v, g_w, g_v, acc,
               slots=None, hot=None, hot_x=None, hot_size=0, hot_bf16=False,
               hg_w=None, hg_v=None, snap_w=None, snap_v=None) -> None:
    """Accumulate one batch's gradients into ``g_w``/``g_v`` (at the
    keys' rows, or at ``slots``' rows in index mode), its hot plane's
    into ``hg_w``/``hg_v``, and its log-loss and weight sums into
    ``acc``.  CPU tensors take the plain version; CUDA tensors launch
    K2."""
    _check(keys, x, labels, weights, w, v, g_w, g_v, acc, slots)
    _check_head(keys, hot, hot_x, hot_size, w, v, hg_w, hg_v, snap_w, snap_v)
    if keys.device.type == "cpu":
        train_plain(keys, x, labels, weights, num_real, w, v, g_w, g_v, acc,
                    slots, hot, hot_x, hot_size, hot_bf16, hg_w, hg_v, snap_w,
                    snap_v)
        return
    if keys.device.type != "cuda":
        raise ValueError(f"train_step: unsupported device {keys.device}")
    lib = _lib()
    b, k = keys.shape
    kh = hot.shape[1] if hot is not None else 0

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(keys.device):
        rc = lib.xf_train_step(
            keys.data_ptr(),
            x.data_ptr() if x is not None else None,
            labels.data_ptr(),
            weights.data_ptr(),
            1 if labels.dtype == torch.uint8 else 0,
            float(num_real),
            w.data_ptr(),
            v.data_ptr() if v is not None else None,
            slots.data_ptr() if slots is not None else None,
            g_w.data_ptr(),
            g_v.data_ptr() if g_v is not None else None,
            acc.data_ptr(),
            b,
            k,
            v.shape[1] if v is not None else 0,
            ptr(hot) if kh else None,
            ptr(hot_x) if kh else None,
            1 if kh and hot.dtype == torch.int16 else 0,
            hot_size if (kh or snap_w is not None) else 0,
            1 if kh and hot_bf16 else 0,
            kh,
            ptr(hg_w),
            ptr(hg_v),
            ptr(snap_w),
            ptr(snap_v),
            torch.cuda.current_stream(keys.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"train kernel launch failed: CUDA error {rc}")
    train_step.launches += 1


train_step.launches = 0
