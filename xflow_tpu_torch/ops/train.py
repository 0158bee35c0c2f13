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
            vp, vp, vp, vp, ci, cf, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp,
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


def train_plain(keys, x, labels, weights, num_real, w, v, g_w, g_v, acc,
                slots=None) -> None:
    """K2's plain PyTorch version, step for step the reference's dense
    ``_train_impl`` up to the optimizer: decode the wire (padding key -1
    → mask 0, key 0), gather rows (padding reads row 0 and is masked
    out), the model's logit and explicit gradient, the residual, the
    scatter-add of live occurrences (at ``slots`` in index mode), and
    the log-loss sum."""
    mask = (keys >= 0).to(torch.float32)
    batch = {
        "keys": torch.clamp(keys, min=0).long(),
        "vals": mask if x is None else x,
        "mask": mask,
        "labels": labels.to(torch.float32),
        "weights": weights.to(torch.float32),
    }
    model = LRModel() if v is None else FMModel(v_dim=v.shape[1])
    rows = {"w": w[batch["keys"]]}
    if v is not None:
        rows["v"] = v[batch["keys"]]
    pctr = sigmoid_ref(model.logit(rows, batch))
    residual = (pctr - batch["labels"]) * batch["weights"] / num_real
    # The reference drops padding occurrences (sentinel key T, mode=
    # "drop", step.py:923).  Their x is 0, so their gradients are
    # exactly +-0 and adding them at the clamped row 0 leaves every
    # value as dropping would — without the host sync that selecting
    # the live occurrences would cost.
    dst = batch["keys"] if slots is None else torch.clamp(slots, min=0).long()
    flat_keys = dst.reshape(-1)
    gbufs = {"w": g_w, "v": g_v}
    for name, g in model.grad_logit(rows, batch).items():
        occ = g * residual[:, None, None]
        gbufs[name].index_add_(0, flat_keys, occ.reshape(-1, occ.shape[-1]))
    acc[0] += logloss_sum(batch["labels"], pctr, batch["weights"])
    acc[1] += torch.sum(batch["weights"])


def train_step(keys, x, labels, weights, num_real, w, v, g_w, g_v, acc,
               slots=None) -> None:
    """Accumulate one batch's gradients into ``g_w``/``g_v`` (at the
    keys' rows, or at ``slots``' rows in index mode) and its log-loss
    and weight sums into ``acc``.  CPU tensors take the plain version;
    CUDA tensors launch K2."""
    _check(keys, x, labels, weights, w, v, g_w, g_v, acc, slots)
    if keys.device.type == "cpu":
        train_plain(keys, x, labels, weights, num_real, w, v, g_w, g_v, acc,
                    slots)
        return
    if keys.device.type != "cuda":
        raise ValueError(f"train_step: unsupported device {keys.device}")
    lib = _lib()
    b, k = keys.shape
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
            torch.cuda.current_stream(keys.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"train kernel launch failed: CUDA error {rc}")
    train_step.launches += 1


train_step.launches = 0
