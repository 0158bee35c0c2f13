"""K1, the fused scoring kernel: wrapper, plain version and binding.

``score(keys, x, w, v)`` returns the clamped-sigmoid pctr [B] of LR
(``v`` None) or FM for sentinel-coded keys.  On CUDA tensors it launches
the hand-written kernel in csrc/score.cu (which names the JAX regions it
replaces and states its bound); on CPU tensors it runs
:func:`score_plain`, the literal PyTorch transcription of the reference's
``_expand_wire`` → gather → ``masked_x``/``linear_term``/
``fm_pair_pieces`` → ``sigmoid_ref``.  There is no fallback: a CUDA
tensor launches the kernel or raises.

``score.launches`` counts kernel launches (never plain-version calls),
so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from xflow_tpu_torch.models.blocks import fm_pair_pieces, linear_term, masked_x
from xflow_tpu_torch.utils.metrics import sigmoid_ref

# the kernel's register-resident D capacity (csrc/score.cu kMaxDim);
# PredictEngine.load refuses a wider FM v table
MAX_DIM = 32
_I32_MAX = 2**31 - 1

_bound: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        from xflow_tpu_torch.ops.build import load_library

        lib = load_library("score")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.xf_score.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.xf_score.restype = ci
        lib.xf_score_max_dim.argtypes = []
        lib.xf_score_max_dim.restype = ci
        if lib.xf_score_max_dim() != MAX_DIM:
            raise RuntimeError(
                f"csrc/score.cu kMaxDim {lib.xf_score_max_dim()} != "
                f"ops/score.py MAX_DIM {MAX_DIM}"
            )
        _bound = lib
    return _bound


def _check(keys, x, w, v) -> None:
    if keys.dtype != torch.int32 or keys.dim() != 2:
        raise ValueError(f"keys must be int32 [B, K], got {keys.dtype} {tuple(keys.shape)}")
    if w.dtype != torch.float32 or w.dim() != 2 or w.shape[1] != 1:
        raise ValueError(f"w must be float32 [T, 1], got {w.dtype} {tuple(w.shape)}")
    if w.shape[0] > _I32_MAX:
        raise ValueError(f"table of {w.shape[0]} rows does not fit int32 keys")
    tensors = [("keys", keys), ("w", w)]
    if x is not None:
        if x.dtype != torch.float32 or x.shape != keys.shape:
            raise ValueError(
                f"x must be float32 {tuple(keys.shape)}, got {x.dtype} {tuple(x.shape)}"
            )
        tensors.append(("x", x))
    if v is not None:
        if v.dtype != torch.float32 or v.dim() != 2 or v.shape[0] != w.shape[0]:
            raise ValueError(
                f"v must be float32 [{w.shape[0]}, D], got {v.dtype} {tuple(v.shape)}"
            )
        if not 1 <= v.shape[1] <= MAX_DIM:
            raise ValueError(f"v width {v.shape[1]} outside [1, {MAX_DIM}]")
        tensors.append(("v", v))
    for name, t in tensors:
        if t.device != keys.device:
            raise ValueError(f"{name} on {t.device}, keys on {keys.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def score_plain(
    keys: torch.Tensor,
    x: torch.Tensor | None,
    w: torch.Tensor,
    v: torch.Tensor | None,
    return_logit: bool = False,
):
    """K1's plain PyTorch version, step for step the reference's
    predict: decode the compact wire (padding key -1 → mask 0, key 0),
    gather rows (padding reads row 0 and is masked out), reduce, clamp."""
    mask = (keys >= 0).to(torch.float32)
    batch = {
        "keys": torch.clamp(keys, min=0).long(),
        "vals": mask if x is None else x,
        "mask": mask,
    }
    xm = masked_x(batch)
    logit = linear_term(w[batch["keys"]], xm)
    if v is not None:
        sum_vx, sum_vx2 = fm_pair_pieces(v[batch["keys"]], xm)
        # No ½ factor: fm_worker.cc:82,86.
        logit = logit + torch.sum(sum_vx * sum_vx - sum_vx2, dim=-1)
    pctr = sigmoid_ref(logit)
    return (pctr, logit) if return_logit else pctr


def score(
    keys: torch.Tensor,
    x: torch.Tensor | None,
    w: torch.Tensor,
    v: torch.Tensor | None,
    return_logit: bool = False,
):
    """pctr [B] (and the logit [B] with ``return_logit``) for
    sentinel-coded keys [B, K]; ``x`` None means x = 1 on live slots.
    CPU tensors take the plain version; CUDA tensors launch K1."""
    _check(keys, x, w, v)
    if keys.device.type == "cpu":
        return score_plain(keys, x, w, v, return_logit)
    if keys.device.type != "cuda":
        raise ValueError(f"score: unsupported device {keys.device}")
    lib = _lib()
    b, k = keys.shape
    pctr = torch.empty(b, dtype=torch.float32, device=keys.device)
    logit = torch.empty_like(pctr) if return_logit else None
    with torch.cuda.device(keys.device):
        rc = lib.xf_score(
            keys.data_ptr(),
            x.data_ptr() if x is not None else None,
            w.data_ptr(),
            v.data_ptr() if v is not None else None,
            pctr.data_ptr(),
            logit.data_ptr() if logit is not None else None,
            b,
            k,
            v.shape[1] if v is not None else 0,
            torch.cuda.current_stream(keys.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"score kernel launch failed: CUDA error {rc}")
    score.launches += 1
    return (pctr, logit) if return_logit else pctr


score.launches = 0
