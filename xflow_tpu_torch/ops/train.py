"""K2, the fused sparse train step: wrapper, plain version and binding.

``train_step(keys, x, labels, weights, num_real, w, v, g_w, g_v, acc)``
runs one dense-mode forward/backward for LR (``v`` None) or FM over
sentinel-coded keys [B, K] and ACCUMULATES into its outputs: the
residual-scaled per-occurrence gradients are scatter-added into ``g_w``
[T, 1] and ``g_v`` [T, D], and ``acc`` float64 [2] (csrc/train.cu says
why) gains the batch's log-loss sum and weight sum.  Any ``v`` width
runs (D in tiles of 32).  ``form`` names the model's form, as K1's
(ops/score.py): ``"lr"``/``"fm"`` (``form=None``: by whether ``v`` is
given), ``"mvm"`` (B9: no ``w``, ``g_w``, ``hg_w`` or ``snap_w``; each
present slot's gradient prod / own * x, zero under the guard and for
fields outside [0, max_fields), lands where FM's would, in every mode
below) and ``"ffm"`` (B10: ``w`` and ``v`` [T, F*D]; each slot's w
gradient x * r, and its v gradient ``FFMModel.grad_logit``'s times r,
zero for fields outside [0, F); the residual r is the UNCLAMPED
sigmoid's, (sigmoid(logit) - y) * weight / num_real, as the reference's
autodiff loss ``softplus(logit) - y * logit`` gives it, while pctr and
the log-loss keep ``sigmoid_ref``'s clamp; with the hot plane, the bf16
flag rounds w's hot rows and gradients alone, since v opts out of the
hot path; there is no window-start mode, which the hot inner alone
uses and FFM refuses).  The field forms read ``fields``, ``hot_fields``
and ``max_fields`` as K1 does.  ``x`` None means x = 1 on live slots (the compact
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
calls).  ``row_chunks`` is read by the plain version alone: it takes
the batch in that many row ranges, each through the whole forward and
backward with the batch's ``num_real``, and sums them into the same
outputs, which bounds FFM's [B, K, F*D] and [B, F, F*D] intermediates as
the reference's dense ``microbatch`` does (the kernel builds none).
"""

from __future__ import annotations

import ctypes

import torch

from xflow_tpu_torch.ops.hot import hot_scatter
from xflow_tpu_torch.ops.score import (
    FORM_CODES,
    check_fields,
    field_stage,
    check_hot,
    check_stage_abi,
    check_tables,
    opted_out_tables,
    plain_model,
    plain_view,
    resolve_form,
)
from xflow_tpu_torch.utils.metrics import logloss_sum, sigmoid_ref

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
            ci, vp, vp, ci, ci,  # form, fields, hot_fields, f_i32, S
            vp, vp,  # the device-memory stage, stream
        ]
        lib.xf_train_step.restype = ci
        lib.xf_train_stage_bytes.argtypes = [ci] * 6
        lib.xf_train_stage_bytes.restype = ctypes.c_longlong
        ip = ctypes.POINTER(ci)
        lib.xf_train_table_shape.argtypes = [ci, ci, ci, ci, ci, ip, ip, ip]
        lib.xf_train_table_shape.restype = ci
        check_stage_abi(lib)
        _bound = lib
    return _bound


def table_shape(b: int, k: int, kh: int, d: int, lw_u8: bool = True) -> dict:
    """The LR/FM form's launch shape on this card for a batch of ``b``
    rows, ``k`` cold and ``kh`` hot slots, v width ``d`` (0: LR): its
    grid, warps a block and table entries a block (0: the table is off).
    Block ``i`` walks the rows ``r`` with ``(r // warps) % grid == i``."""
    out = [ctypes.c_int(0) for _ in range(3)]
    rc = _lib().xf_train_table_shape(b, k, kh, d, int(lw_u8), *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError(f"train_step: table shape failed: CUDA error {rc}")
    return dict(zip(("grid", "warps", "entries"), (o.value for o in out)))


def _check(keys, x, labels, weights, w, v, g_w, g_v, acc, slots, form, max_fields) -> None:
    tensors = check_tables(keys, x, w, v, form, max_fields)
    b = keys.shape[0]
    t = (w if w is not None else v).shape[0]
    if labels.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"labels must be uint8 or float32, got {labels.dtype}")
    if labels.shape != (b,) or weights.shape != (b,) or weights.dtype != labels.dtype:
        raise ValueError(
            f"labels/weights must be [{b}] of one dtype, got "
            f"{labels.dtype} {tuple(labels.shape)} / {weights.dtype} "
            f"{tuple(weights.shape)}"
        )
    if acc.shape != (2,) or acc.dtype != torch.float64:
        raise ValueError("acc must be float64 [2]")
    tensors += [("labels", labels), ("weights", weights), ("acc", acc)]
    # the gradient buffers' rows: T (dense mode) or the slots' M >= B*K
    rows = t if slots is None else max(keys.numel(), 1)
    grads = [("g_w", g_w, w, 1, "w and g_w come together (LR, FM, FFM) or not at all (MVM)"),
             ("g_v", g_v, v, v.shape[1] if v is not None else 0,
              "v and g_v come together (FM, MVM, FFM) or not at all (LR)")]
    for name, g, table, width, pairing in grads:
        if (table is None) != (g is None):
            raise ValueError(pairing)
        if g is None:
            continue
        if (g.dtype != torch.float32 or g.dim() != 2 or g.shape[1] != width
                or (g.shape[0] != rows if slots is None else g.shape[0] < rows)):
            raise ValueError(
                f"{name} must be float32 [{rows}, {width}] (dense) or "
                f"[>= B*K, {width}] (index mode), got {g.dtype} {tuple(g.shape)}"
            )
        tensors.append((name, g))
    if g_w is not None and g_v is not None and g_w.shape[0] != g_v.shape[0]:
        raise ValueError(f"g_w has {g_w.shape[0]} rows, g_v {g_v.shape[0]}")
    if slots is not None:
        if slots.dtype != torch.int32 or slots.shape != keys.shape:
            raise ValueError(
                f"slots must be int32 {tuple(keys.shape)}, got {slots.dtype} "
                f"{tuple(slots.shape)}"
            )
        tensors.append(("slots", slots))
    for name, tt in tensors:
        if tt.device != keys.device:
            raise ValueError(f"{name} on {tt.device}, keys on {keys.device}")
        if not tt.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_head(keys, hot, hot_x, hot_size, w, v, hg_w, hg_v, snap_w, snap_v) -> None:
    """The hot plane, its [H, D] gradient destination and the window-
    start snapshot: each [H, dim] float32 and contiguous, beside w/v."""
    if hot is None and (hg_w is not None or hg_v is not None):
        raise ValueError("hg_w/hg_v need a hot plane")
    windowed = snap_w is not None or snap_v is not None
    if hot is None and not windowed:
        return
    table = w if w is not None else v
    if not 0 < hot_size <= table.shape[0]:
        raise ValueError(f"hot_size {hot_size} outside (0, {table.shape[0]}]")
    heads = []
    if hot is not None:
        check_hot(keys, hot, hot_x, hot_size, table)
        heads += [("hg_w", hg_w, w), ("hg_v", hg_v, v)]
    if windowed:
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
                     snap_v=None, fields=None, hot_fields=None, max_fields=0,
                     form=None):
    """The plain forward and backward up to the scatter: the forward's
    plain half (ops/score.py ``plain_view``: the wire decoded, cold rows
    gathered — from the window-start head at keys < H when given — and
    the hot rows through ``hot_gather``), the model's logit and explicit
    gradient times the residual (the unclamped sigmoid's for an
    ``autodiff`` model: the reference's step.py:59-74).  Returns (the
    per-occurrence gradients {table: [B, Kh + K, dim]}, hot slots first
    and not yet rounded to bfloat16, the hot keys [B, Kh] or None, pctr,
    the model's batch view)."""
    model = plain_model(resolve_form(form, v, fields), v, max_fields)
    rows, batch, hk = plain_view(keys, x, w, v, hot, hot_x, hot_size,
                                 hot_bf16, snap_w, snap_v, fields, hot_fields,
                                 opted_out_tables(model))
    batch["labels"] = labels.to(torch.float32)
    batch["weights"] = weights.to(torch.float32)
    logit = model.logit(rows, batch)
    pctr = sigmoid_ref(logit)
    p = torch.sigmoid(logit) if getattr(model, "autodiff", False) else pctr
    residual = (p - batch["labels"]) * batch["weights"] / num_real
    occ = {name: g * residual[:, None, None]
           for name, g in model.grad_logit(rows, batch).items()}
    return occ, hk, pctr, batch


def train_plain(keys, x, labels, weights, num_real, w, v, g_w, g_v, acc,
                slots=None, hot=None, hot_x=None, hot_size=0, hot_bf16=False,
                hg_w=None, hg_v=None, snap_w=None, snap_v=None, fields=None,
                hot_fields=None, max_fields=0, form=None, row_chunks=1) -> None:
    """K2's plain PyTorch version, step for step the reference's
    ``_train_impl`` up to the optimizer: ``occurrence_grads``, the
    scatter-add of live cold occurrences (at ``slots`` in index mode),
    ``hot_scatter`` of the hot ones into ``hg_w``/``hg_v`` (a plain
    float32 scatter for a table that opts out of the hot path), and the
    log-loss sum; in ``row_chunks`` row ranges (module docstring)."""
    b = keys.shape[0]
    if row_chunks > 1 and b > 1:
        step = -(-b // row_chunks)
        for r0 in range(0, b, step):
            rows = slice(r0, r0 + step)

            def part(t):
                return t[rows] if t is not None else None

            train_plain(part(keys), part(x), part(labels), part(weights), num_real, w, v,
                        g_w, g_v, acc, part(slots), part(hot), part(hot_x), hot_size,
                        hot_bf16, hg_w, hg_v, snap_w, snap_v, part(fields),
                        part(hot_fields), max_fields, form)
        return
    occs, hk, pctr, batch = occurrence_grads(keys, x, labels, weights, num_real,
                                             w, v, hot, hot_x, hot_size, hot_bf16,
                                             snap_w, snap_v, fields, hot_fields,
                                             max_fields, form)
    opted_out = opted_out_tables(plain_model(resolve_form(form, v, fields), v, max_fields))
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
            if name in opted_out:
                hbufs[name] += hot_scatter(hot_keys_eff.reshape(-1),
                                           occ[:, :kh].reshape(-1, d), hot_size)
            else:
                hbufs[name] += hot_scatter(hot_keys_eff.reshape(-1),
                                           occ[:, :kh].reshape(-1, d), hot_size,
                                           dtype=dtype, impl=impl)
    acc[0] += logloss_sum(batch["labels"], pctr, batch["weights"])
    acc[1] += torch.sum(batch["weights"])


def train_step(keys, x, labels, weights, num_real, w, v, g_w, g_v, acc,
               slots=None, hot=None, hot_x=None, hot_size=0, hot_bf16=False,
               hg_w=None, hg_v=None, snap_w=None, snap_v=None, fields=None,
               hot_fields=None, max_fields=0, form=None, row_chunks=1) -> None:
    """Accumulate one batch's gradients into ``g_w``/``g_v`` (at the
    keys' rows, or at ``slots``' rows in index mode), its hot plane's
    into ``hg_w``/``hg_v``, and its log-loss and weight sums into
    ``acc``; ``form`` names the model's form (module docstring).  CPU
    tensors take the plain version; CUDA tensors launch K2."""
    form = resolve_form(form, v, fields)
    _check(keys, x, labels, weights, w, v, g_w, g_v, acc, slots, form, max_fields)
    _check_head(keys, hot, hot_x, hot_size, w, v, hg_w, hg_v, snap_w, snap_v)
    check_fields(keys, fields, hot, hot_fields, max_fields, form)
    if form == "ffm" and (snap_w is not None or snap_v is not None):
        raise ValueError("the FFM form has no window-start mode: the hot inner, which "
                         "alone uses it, is refused for FFM (TableSpec.hot)")
    if keys.device.type == "cpu":
        train_plain(keys, x, labels, weights, num_real, w, v, g_w, g_v, acc,
                    slots, hot, hot_x, hot_size, hot_bf16, hg_w, hg_v, snap_w,
                    snap_v, fields, hot_fields, max_fields, form, row_chunks)
        return
    if keys.device.type != "cuda":
        raise ValueError(f"train_step: unsupported device {keys.device}")
    lib = _lib()
    b, k = keys.shape
    kh = hot.shape[1] if hot is not None else 0
    windowed = snap_w is not None or snap_v is not None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    d = v.shape[1] if v is not None else 0
    stage = field_stage(lib.xf_train_stage_bytes, form, max_fields, b, k, kh, d,
                        keys.device)
    with torch.cuda.device(keys.device):
        rc = lib.xf_train_step(
            keys.data_ptr(),
            ptr(x),
            labels.data_ptr(),
            weights.data_ptr(),
            1 if labels.dtype == torch.uint8 else 0,
            float(num_real),
            ptr(w),
            ptr(v),
            ptr(slots),
            ptr(g_w),
            ptr(g_v),
            acc.data_ptr(),
            b,
            k,
            d,
            ptr(hot) if kh else None,
            ptr(hot_x) if kh else None,
            1 if kh and hot.dtype == torch.int16 else 0,
            hot_size if (kh or windowed) else 0,
            1 if kh and hot_bf16 else 0,
            kh,
            ptr(hg_w),
            ptr(hg_v),
            ptr(snap_w),
            ptr(snap_v),
            FORM_CODES[form],
            ptr(fields),
            ptr(hot_fields) if kh else None,
            1 if fields is not None and fields.dtype == torch.int32 else 0,
            max_fields,
            ptr(stage),
            torch.cuda.current_stream(keys.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"train kernel launch failed: CUDA error {rc}")
    train_step.launches += 1


train_step.launches = 0
