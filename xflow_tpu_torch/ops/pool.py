"""K7 ``field_pool`` and K8 ``field_pool_grad``: B11, the embedding
tower of wide_deep, dcn and two_tower — wrappers, plain versions and
bindings.

``field_pool(keys, x, fields, emb, max_fields, w=None, ...)`` returns
``(pooled, wide)``: the value-scaled ``emb`` rows of each example's
slots summed per field into pooled float32 [B, F, E] (F =
``max_fields``; a slot whose field lies outside [0, F), negatives
included, drops out), and with ``w`` the wide term wide float32 [B] =
sum over the live slots of w[key] * x, whatever the field (None
without ``w``).  The planes are the wires' (ops/score.py): ``keys``
int32 [B, K] sentinel-coded, ``x`` float32 or None (x = 1 on live
slots), ``fields`` uint8 (compact and dictionary wires, 255 for
anything outside [0, 255]) or int32 (full wire); the hot plane ``hot``
[B, Kh] (int16 = u16 bits with 0xFFFF padding, or int32 with -1),
``hot_x``, ``hot_fields``, ``hot_size``, hot slots first, and
``hot_bf16``, which rounds the hot rows of ``w`` and ``emb`` to
bfloat16 (the reference's ``hot_impl="mxu"`` with ``hot_dtype=
"bfloat16"``: both are MXU tables in these families).  Window-start
mode (``snap_emb``, and ``snap_w`` beside ``w``: [H, *] head snapshots;
the hot inner): a cold key < H reads its rows from the snapshots, as
K2's window-start mode does.

``field_pool_grad(keys, x, fields, dP, r, logit, labels, weights,
num_fields, g_emb, acc, ...)`` ACCUMULATES the backward: each slot with
a valid field adds x * dP[b, f, :] into ``g_emb``, each live slot x *
r[b] into ``g_w`` (when given), and ``acc`` float64 [2] gains the
clamped pctr's log-loss sum and the weight sum (``logit``, ``labels``
and ``weights``: uint8 or float32).  ``dP`` [B, F, E] is dloss/dpooled
and ``r`` [B] the residual, the unclamped sigmoid's (models/base.py's
``AutodiffModel``; the caller forms both).  Destinations as K2's
(ops/train.py): rows ``keys`` of [T, D] buffers, or in index mode
(``slots``, K4's slot plane) rows ``slots`` of [M, D] sums; the hot
plane's at its keys of ``hg_w``/``hg_emb`` [H, D], rounded to bfloat16
before the add under ``hot_bf16``.

On CUDA tensors each launches its hand-written kernel in
csrc/pool.cu (which names the JAX regions they replace and states their
bound); on CPU tensors it runs :func:`field_pool_plain` /
:func:`field_pool_grad_plain`, the reference's expressions
(``field_sum_tower``'s one-hot einsum, autodiff's gradient of it).
There is no fallback: a CUDA tensor launches the kernel or raises.
``field_pool.launches`` and ``field_pool_grad.launches`` count kernel
launches, never plain-version calls.
"""

from __future__ import annotations

import ctypes

import torch

from xflow_tpu_torch.models.blocks import field_sum_tower, linear_term
from xflow_tpu_torch.ops.hot import hot_scatter
from xflow_tpu_torch.ops.score import check_hot, hot_plane_keys, plain_view
from xflow_tpu_torch.utils.metrics import logloss_sum, sigmoid_ref

# K8 stages a row's Kh + K slots in one block's shared memory
# (csrc/pool.cu): POOL_BYTES_PER_SLOT a slot within POOL_STAGE_BYTES,
# the 48 KiB a block gets without the opt-in less the static part.  That
# caps a row at POOL_MAX_SLOTS slots, for K7 too (its warp's stage fits
# any such row).
POOL_BYTES_PER_SLOT = 12
POOL_STAGE_BYTES = 48 * 1024 - 64
POOL_MAX_SLOTS = POOL_STAGE_BYTES // POOL_BYTES_PER_SLOT

_bound: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        from xflow_tpu_torch.ops.build import load_library

        lib = load_library("pool")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.xf_field_pool.argtypes = [
            vp, vp, vp, vp, vp, vp,  # keys, x, fields, hot, hot_x, hot_fields
            ci, ci, ci, ci, ci, ci,  # hot_u16, H, bf16, KH, f_i32, F
            vp, vp, vp, vp,  # w, emb, snap_w, snap_emb
            ci, vp, vp, ci, ci, vp,  # E, pooled, wide, B, K, stream
        ]
        lib.xf_field_pool.restype = ci
        lib.xf_field_pool_grad.argtypes = [
            vp, vp, vp, vp, vp, vp,
            ci, ci, ci, ci, ci, ci,
            vp, vp, vp, vp, vp, ci,  # dP, r, logit, labels, weights, lw_u8
            vp, vp, vp, vp, vp,  # slots, gw, gemb, hgw, hgemb
            ci, vp, ci, ci, vp,  # E, acc, B, K, stream
        ]
        lib.xf_field_pool_grad.restype = ci
        lib.xf_pool_max_slots.argtypes = []
        lib.xf_pool_max_slots.restype = ci
        if lib.xf_pool_max_slots() != POOL_MAX_SLOTS:
            raise RuntimeError("csrc/pool.cu's stage differs from ops/pool.py's "
                               "POOL_MAX_SLOTS")
        _bound = lib
    return _bound


def _same_place(keys, named) -> None:
    for name, t in named:
        if t is None:
            continue
        if t.device != keys.device:
            raise ValueError(f"{name} on {t.device}, keys on {keys.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_pool_slots(slots: int) -> None:
    """Refuse a row wider than K7's and K8's shared-memory stage."""
    if slots > POOL_MAX_SLOTS:
        raise ValueError(
            f"pooled rows of {slots} slots (hot + cold) exceed K7's and K8's "
            f"shared-memory stage: {POOL_BYTES_PER_SLOT} B a slot in at most "
            f"{POOL_STAGE_BYTES} B a block, so at most {POOL_MAX_SLOTS} slots "
            "(csrc/pool.cu)"
        )


def check_planes(keys, x, fields, hot, hot_x, hot_fields, hot_size: int, table,
                 max_fields: int) -> None:
    """The planes both kernels read: int32 keys [B, K], float32 x or
    None, uint8/int32 fields beside them, a hot plane with its fields
    (and only then), a positive ``max_fields``."""
    if keys.dtype != torch.int32 or keys.dim() != 2:
        raise ValueError(f"keys must be int32 [B, K], got {keys.dtype} {tuple(keys.shape)}")
    if x is not None and (x.dtype != torch.float32 or x.shape != keys.shape):
        raise ValueError(f"x must be float32 {tuple(keys.shape)}")
    if fields is None or fields.dtype not in (torch.uint8, torch.int32) \
            or fields.shape != keys.shape:
        raise ValueError(f"fields must be uint8 or int32 {tuple(keys.shape)}")
    if max_fields < 1:
        raise ValueError(f"max_fields must be positive, got {max_fields}")
    if (hot is None) != (hot_fields is None):
        raise ValueError("hot_fields come with a hot plane, and only then")
    if hot is not None:
        check_hot(keys, hot, hot_x, hot_size, table)
        if hot_fields.dtype != fields.dtype or hot_fields.shape != hot.shape:
            raise ValueError(f"hot_fields must be {fields.dtype} {tuple(hot.shape)}")
    check_pool_slots(keys.shape[1] + (hot.shape[1] if hot is not None else 0))
    _same_place(keys, [("x", x), ("fields", fields), ("hot_fields", hot_fields)])


def _check_table(name, t, rows: int | None, width: int | None):
    if t.dtype != torch.float32 or t.dim() != 2 or (width is not None and t.shape[1] != width) \
            or (rows is not None and t.shape[0] != rows):
        raise ValueError(f"{name} must be float32 [{rows or 'T'}, {width or 'E'}], got "
                         f"{t.dtype} {tuple(t.shape)}")


def field_pool_plain(keys, x, fields, emb, max_fields: int, w=None, hot=None,
                     hot_x=None, hot_fields=None, hot_size: int = 0,
                     hot_bf16: bool = False, snap_w=None, snap_emb=None):
    """K7's plain PyTorch version, the reference's forward: the planes
    decoded and the rows gathered (ops/score.py ``plain_view``: hot rows
    through ``hot_gather``, bfloat16-rounded under the flag), then
    ``field_sum_tower`` and ``linear_term`` of ``masked_x``."""
    rows, view, _ = plain_view(keys, x, w, emb, hot, hot_x, hot_size, hot_bf16,
                               snap_w=snap_w, snap_v=snap_emb, fields=fields,
                               hot_fields=hot_fields)
    xm = view["vals"] * view["mask"]
    pooled = field_sum_tower(rows["v"], xm, view["slots"], max_fields)
    wide = linear_term(rows["w"], xm) if w is not None else None
    return pooled, wide


def field_pool(keys, x, fields, emb, max_fields: int, w=None, hot=None, hot_x=None,
               hot_fields=None, hot_size: int = 0, hot_bf16: bool = False,
               snap_w=None, snap_emb=None):
    """(pooled [B, F, E], wide [B] or None) for the planes (module
    docstring).  CPU tensors take the plain version; CUDA tensors launch
    K7."""
    _check_table("emb", emb, None, None)
    if w is not None:
        _check_table("w", w, emb.shape[0], 1)
    check_planes(keys, x, fields, hot, hot_x, hot_fields, hot_size, emb, max_fields)
    if snap_emb is not None:
        if hot is None or (snap_w is None) != (w is None):
            raise ValueError("window-start mode needs a hot plane, snap_emb, and "
                             "snap_w beside w")
        _check_table("snap_emb", snap_emb, hot_size, emb.shape[1])
        if snap_w is not None:
            _check_table("snap_w", snap_w, hot_size, 1)
    elif snap_w is not None:
        raise ValueError("snap_w needs snap_emb")
    _same_place(keys, [("emb", emb), ("w", w), ("snap_w", snap_w), ("snap_emb", snap_emb)])
    if keys.device.type == "cpu":
        return field_pool_plain(keys, x, fields, emb, max_fields, w, hot, hot_x,
                                hot_fields, hot_size, hot_bf16, snap_w, snap_emb)
    if keys.device.type != "cuda":
        raise ValueError(f"field_pool: unsupported device {keys.device}")
    lib = _lib()
    b, k = keys.shape
    kh = hot.shape[1] if hot is not None else 0
    e = emb.shape[1]
    pooled = torch.empty((b, max_fields, e), dtype=torch.float32, device=keys.device)
    wide = torch.empty(b, dtype=torch.float32, device=keys.device) if w is not None else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(keys.device):
        rc = lib.xf_field_pool(
            keys.data_ptr(), ptr(x), fields.data_ptr(), ptr(hot), ptr(hot_x),
            ptr(hot_fields), 1 if kh and hot.dtype == torch.int16 else 0,
            hot_size if kh else 0, 1 if kh and hot_bf16 else 0, kh,
            1 if fields.dtype == torch.int32 else 0, max_fields, ptr(w),
            emb.data_ptr(), ptr(snap_w), ptr(snap_emb), e, pooled.data_ptr(),
            ptr(wide), b, k,
            torch.cuda.current_stream(keys.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"field_pool kernel launch failed: CUDA error {rc}")
    field_pool.launches += 1
    return pooled, wide


field_pool.launches = 0


def occurrence_grads(keys, x, fields, dP, r, max_fields: int, hot=None, hot_x=None,
                     hot_fields=None, hot_size: int = 0, with_w: bool = True):
    """The per-occurrence gradients autodiff gives the gathered rows,
    hot slots first: {"emb": [B, Kh + K, E] = x * (onehot @ dP), "w":
    [B, Kh + K, 1] = x * r (with ``with_w``)}, and the hot keys [B, Kh]
    (-1 on padding) or None."""
    mask = (keys >= 0).to(torch.float32)
    xm = mask if x is None else x * mask
    slots = fields.long()
    hk = None
    if hot is not None:
        hk = hot_plane_keys(hot, hot_size)
        hmask = (hk >= 0).to(torch.float32)
        xm = torch.cat([hmask if hot_x is None else hot_x * hmask, xm], dim=1)
        slots = torch.cat([hot_fields.long(), slots], dim=1)
    onehot = (slots[..., None] == torch.arange(max_fields, device=slots.device)
              ).to(torch.float32)  # [B, n, F]
    occ = {"emb": torch.einsum("bkf,bfe->bke", onehot, dP) * xm[..., None]}
    if with_w:
        occ["w"] = (xm * r[:, None])[..., None]
    return occ, hk


def field_pool_grad_plain(keys, x, fields, dP, r, logit, labels, weights,
                          max_fields: int, g_emb, acc, g_w=None, slots=None,
                          hot=None, hot_x=None, hot_fields=None, hot_size: int = 0,
                          hot_bf16: bool = False, hg_w=None, hg_emb=None) -> None:
    """K8's plain PyTorch version: :func:`occurrence_grads`, the
    scatter-add of the cold occurrences at the keys (or ``slots``) —
    padding's exact zeros land at the clamped row 0, as in K2's plain
    version, so nothing syncs the host — the hot ones through
    ``hot_scatter`` (bfloat16 under the flag), then ``logloss_sum`` of
    the clamped pctr."""
    occs, hk = occurrence_grads(keys, x, fields, dP, r, max_fields, hot, hot_x,
                                hot_fields, hot_size, with_w=g_w is not None)
    kh = 0 if hk is None else hk.shape[1]
    cold = torch.clamp(keys if slots is None else slots, min=0).long().reshape(-1)
    impl, dtype = ("mxu", torch.bfloat16) if hot_bf16 else ("seg", torch.float32)
    for name, occ in occs.items():
        d = occ.shape[-1]
        g, hg = (g_emb, hg_emb) if name == "emb" else (g_w, hg_w)
        g.index_add_(0, cold, occ[:, kh:].reshape(-1, d))
        if kh:
            eff = torch.where(hk >= 0, hk, torch.full_like(hk, hot_size))
            hg += hot_scatter(eff.reshape(-1), occ[:, :kh].reshape(-1, d), hot_size,
                              dtype=dtype, impl=impl)
    lab = labels.to(torch.float32)
    wt = weights.to(torch.float32)
    acc[0] += logloss_sum(lab, sigmoid_ref(logit), wt)
    acc[1] += torch.sum(wt)


def field_pool_grad(keys, x, fields, dP, r, logit, labels, weights, max_fields: int,
                    g_emb, acc, g_w=None, slots=None, hot=None, hot_x=None,
                    hot_fields=None, hot_size: int = 0, hot_bf16: bool = False,
                    hg_w=None, hg_emb=None) -> None:
    """Accumulate the tower's backward into the gradient buffers and the
    log-loss into ``acc`` (module docstring).  CPU tensors take the plain
    version; CUDA tensors launch K8."""
    b, k = keys.shape
    e = g_emb.shape[1] if g_emb is not None else 0
    check_planes(keys, x, fields, hot, hot_x, hot_fields, hot_size,
                 g_emb if hg_emb is None else hg_emb, max_fields)
    if dP.dtype != torch.float32 or dP.shape != (b, max_fields, e):
        raise ValueError(f"dP must be float32 {(b, max_fields, e)}, got {dP.dtype} "
                         f"{tuple(dP.shape)}")
    for name, t in (("r", r), ("logit", logit)):
        if t.dtype != torch.float32 or t.shape != (b,):
            raise ValueError(f"{name} must be float32 [{b}]")
    if labels.dtype not in (torch.uint8, torch.float32) or labels.shape != (b,) \
            or weights.dtype != labels.dtype or weights.shape != (b,):
        raise ValueError(f"labels/weights must be [{b}] uint8 or float32, of one dtype")
    if acc.shape != (2,) or acc.dtype != torch.float64:
        raise ValueError("acc must be float64 [2]")
    _check_table("g_emb", g_emb, None, e)
    if g_w is not None:
        _check_table("g_w", g_w, g_emb.shape[0], 1)
    if slots is not None:
        if slots.dtype != torch.int32 or slots.shape != keys.shape:
            raise ValueError(f"slots must be int32 {tuple(keys.shape)}")
        need = max(keys.numel(), 1)
        if g_emb.shape[0] < need:
            raise ValueError(f"index mode needs >= {need} gradient rows, g_emb has "
                             f"{g_emb.shape[0]}")
    if hot is not None:
        if hg_emb is None or (g_w is not None) != (hg_w is not None):
            raise ValueError("a hot plane needs hg_emb, and hg_w beside g_w")
        _check_table("hg_emb", hg_emb, hot_size, e)
        if hg_w is not None:
            _check_table("hg_w", hg_w, hot_size, 1)
    elif hg_w is not None or hg_emb is not None:
        raise ValueError("hg_w/hg_emb need a hot plane")
    _same_place(keys, [("dP", dP), ("r", r), ("logit", logit), ("labels", labels),
                       ("weights", weights), ("acc", acc), ("g_emb", g_emb), ("g_w", g_w),
                       ("slots", slots), ("hg_w", hg_w), ("hg_emb", hg_emb)])
    if keys.device.type == "cpu":
        field_pool_grad_plain(keys, x, fields, dP, r, logit, labels, weights, max_fields,
                              g_emb, acc, g_w, slots, hot, hot_x, hot_fields, hot_size,
                              hot_bf16, hg_w, hg_emb)
        return
    if keys.device.type != "cuda":
        raise ValueError(f"field_pool_grad: unsupported device {keys.device}")
    lib = _lib()
    kh = hot.shape[1] if hot is not None else 0

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(keys.device):
        rc = lib.xf_field_pool_grad(
            keys.data_ptr(), ptr(x), fields.data_ptr(), ptr(hot), ptr(hot_x),
            ptr(hot_fields), 1 if kh and hot.dtype == torch.int16 else 0,
            hot_size if kh else 0, 1 if kh and hot_bf16 else 0, kh,
            1 if fields.dtype == torch.int32 else 0, max_fields, dP.data_ptr(),
            r.data_ptr(), logit.data_ptr(), labels.data_ptr(), weights.data_ptr(),
            1 if labels.dtype == torch.uint8 else 0, ptr(slots), ptr(g_w),
            g_emb.data_ptr(), ptr(hg_w), ptr(hg_emb), e, acc.data_ptr(), b, k,
            torch.cuda.current_stream(keys.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"field_pool_grad kernel launch failed: CUDA error {rc}")
    field_pool_grad.launches += 1


field_pool_grad.launches = 0
