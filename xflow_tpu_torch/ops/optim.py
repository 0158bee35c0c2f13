"""K3, the dense-mode optimizer pass: wrapper, plain version and binding.

``optim_update(table, opt)`` applies FTRL or SGD to every element of a
table in place and clears its gradient buffer: ``table`` is one entry
of the training state, ``{"param", "g"}`` plus the optimizer's aux
tensors (``n``, ``z`` for FTRL), all float32 [T, D] on one device.  On
CUDA tensors it launches the hand-written kernel in csrc/optim.cu
(which names the JAX region it replaces and states its bound); on CPU
tensors it runs :func:`optim_plain`, the optimizer's ``update_rows``
written back in place.  The kernel makes 16-byte loads only, so on the
card every tensor must be 16-byte aligned and T*D a multiple of 4 (true
of every table the port allocates); other tensors are refused.  There is no fallback: a CUDA tensor launches
the kernel or raises.

The reference returns new arrays and donates the old ones
(parallel/step.py:402); the port overwrites the state's tensors.

``optim_update.launches`` counts wrapper calls that launched the kernel
(never plain-version calls).
"""

from __future__ import annotations

import ctypes

import torch

from xflow_tpu_torch.optim import FTRL, SGD

_bound: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        from xflow_tpu_torch.ops.build import load_library

        lib = load_library("optim")
        vp, ll, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
        lib.xf_ftrl_update.argtypes = [vp, vp, vp, vp, ll, f, f, f, f, vp]
        lib.xf_ftrl_update.restype = ctypes.c_int
        lib.xf_sgd_update.argtypes = [vp, vp, ll, f, vp]
        lib.xf_sgd_update.restype = ctypes.c_int
        _bound = lib
    return _bound


def _names(opt) -> tuple[str, ...]:
    if isinstance(opt, FTRL):
        return ("param", "n", "z", "g")
    if isinstance(opt, SGD):
        return ("param", "g")
    raise ValueError(f"optim_update: unsupported optimizer {opt!r}")


def _check(table: dict, opt) -> list[torch.Tensor]:
    names = _names(opt)
    tensors = [table[name] for name in names]
    ref = tensors[0]
    if ref.dim() != 2:
        raise ValueError(f"param must be [T, D], got {tuple(ref.shape)}")
    for name, t in zip(names, tensors):
        if t.dtype != torch.float32 or t.shape != ref.shape:
            raise ValueError(
                f"{name} must be float32 {tuple(ref.shape)}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.device != ref.device:
            raise ValueError(f"{name} on {t.device}, param on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return tensors


def optim_plain(table: dict, opt) -> None:
    """K3's plain PyTorch version: the optimizer's ``update_rows`` over
    the whole table (the reference's dense-mode pass,
    step.py:1123-1126), written back in place, then ``g = 0``."""
    _check(table, opt)
    rows = {k: v for k, v in table.items() if k != "g"}
    new = opt.update_rows(rows, table["g"])
    for name, t in new.items():
        table[name].copy_(t)
    table["g"].zero_()


def optim_update(table: dict, opt) -> None:
    """Apply ``opt`` to ``table`` in place and clear ``table["g"]``.
    CPU tensors take the plain version; CUDA tensors launch K3."""
    tensors = _check(table, opt)
    dev = tensors[0].device
    if dev.type == "cpu":
        optim_plain(table, opt)
        return
    if dev.type != "cuda":
        raise ValueError(f"optim_update: unsupported device {dev}")
    count = tensors[0].numel()
    ptrs = [t.data_ptr() for t in tensors]
    if count % 4 or any(p % 16 for p in ptrs):
        raise ValueError(
            "optim_update: the kernel makes 16-byte loads, so every tensor "
            "must be 16-byte aligned and T*D a multiple of 4 (got "
            f"{tuple(tensors[0].shape)})"
        )
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if isinstance(opt, FTRL):
            rc = lib.xf_ftrl_update(
                *ptrs, count, opt.alpha, opt.beta, opt.lambda1, opt.lambda2,
                stream,
            )
        else:
            rc = lib.xf_sgd_update(*ptrs, count, opt.lr, stream)
    if rc != 0:
        raise RuntimeError(f"optim kernel launch failed: CUDA error {rc}")
    optim_update.launches += 1


optim_update.launches = 0
