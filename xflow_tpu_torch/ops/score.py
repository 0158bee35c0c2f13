"""K1, the fused scoring kernel: wrapper, plain version and binding.

``score(keys, x, w, v)`` returns the clamped-sigmoid pctr [B] of LR
(``v`` None) or FM (any ``v`` width: the kernel runs D in tiles of 32)
for sentinel-coded keys, and with ``fields`` given, MVM's (B9: no
``w``; ``fields`` [B, K] and ``hot_fields`` [B, Kh] the field ids,
uint8 as the compact and dictionary wires ship them or int32 as the
full wire does, ``max_fields`` the S of the reference's one-hot; a slot
whose field lies outside [0, S) is dropped).  On CUDA tensors it launches
the hand-written kernel in csrc/score.cu (which names the JAX regions it
replaces and states its bound); on CPU tensors it runs
:func:`score_plain`, the literal PyTorch transcription of the reference's
``_expand_wire`` → gather → the model's ``logit`` (models/) →
``sigmoid_ref``.  There is no fallback: a CUDA
tensor launches the kernel or raises.

The hot plane (B7, the hot table's rows [0, H)): ``hot`` [B, Kh] holds
each row's hot keys, ``uint16`` (as its int16 view, 0xFFFF padding)
or int32 (-1 padding), read in the same pass as the cold plane, hot
entries first as the reference's ``_model_view`` orders them;
``hot_x`` is its values on the full wire (None: x = 1 on live slots);
a hot key outside [0, ``hot_size``) counts as padding, as the
reference's ``hot_gather`` gives it a zero row.  ``hot_bf16`` rounds
the hot plane's rows to bfloat16 (nearest even) before use: the
reference's ``hot_impl="mxu"`` with ``hot_dtype="bfloat16"``
(ops/hot.py).  :func:`plain_view` is the forward's plain half, shared
with K2's plain version.

``score.launches`` counts kernel launches (never plain-version calls),
so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from xflow_tpu_torch.ops.hot import hot_gather
from xflow_tpu_torch.utils.metrics import sigmoid_ref

_I32_MAX = 2**31 - 1
# The MVM forms of K1 and K2 stage each example's Kh + K slots in one
# warp's shared memory (csrc/mvm.cuh: MVM_BYTES_PER_SLOT a slot), and a
# block holds at most MVM_SMEM_BYTES (the H100's and H200's opt-in per
# block): that caps a row at MVM_MAX_SLOTS slots.
MVM_BYTES_PER_SLOT = 148
MVM_SMEM_BYTES = 232_448
MVM_MAX_SLOTS = MVM_SMEM_BYTES // MVM_BYTES_PER_SLOT

_bound: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        from xflow_tpu_torch.ops.build import load_library

        lib = load_library("score")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.xf_score.argtypes = [
            vp, vp, vp, vp, ci, ci, ci,  # keys, x, hot, hot_x, hot_u16, H, bf16
            vp, vp, ci, ci,  # fields, hot_fields, f_i32, S
            vp, vp, vp, vp, ci, ci, ci, ci, vp,  # w, v, pctr, logit, B, K, KH, D
        ]
        lib.xf_score.restype = ci
        check_mvm_stage(lib)
        _bound = lib
    return _bound


def check_mvm_stage(lib: ctypes.CDLL) -> None:
    """The library's MVM stage bytes a slot must be MVM_BYTES_PER_SLOT."""
    lib.xf_mvm_bytes_per_slot.argtypes = []
    lib.xf_mvm_bytes_per_slot.restype = ctypes.c_int
    if lib.xf_mvm_bytes_per_slot() != MVM_BYTES_PER_SLOT:
        raise RuntimeError(
            f"csrc/mvm.cuh kBytesPerSlot {lib.xf_mvm_bytes_per_slot()} != "
            f"ops/score.py MVM_BYTES_PER_SLOT {MVM_BYTES_PER_SLOT}"
        )


def check_mvm_slots(slots: int) -> None:
    """Refuse an MVM row wider than the kernels' shared-memory stage."""
    if slots > MVM_MAX_SLOTS:
        raise ValueError(
            f"MVM rows of {slots} slots (hot + cold) exceed the MVM kernels' "
            f"shared-memory stage: {MVM_BYTES_PER_SLOT} B a slot in one warp, "
            f"at most {MVM_SMEM_BYTES} B a block, so at most {MVM_MAX_SLOTS} "
            "slots (csrc/mvm.cuh)"
        )


def check_fields(keys, fields, hot, hot_fields, max_fields: int) -> None:
    """The MVM form's field planes: ``fields`` beside ``keys`` and
    ``hot_fields`` beside ``hot`` (and only with it), uint8 or int32,
    one dtype, and a positive ``max_fields``."""
    if fields.dtype not in (torch.uint8, torch.int32) or fields.shape != keys.shape:
        raise ValueError(
            f"fields must be uint8 or int32 {tuple(keys.shape)}, got "
            f"{fields.dtype} {tuple(fields.shape)}"
        )
    if (hot is None) != (hot_fields is None):
        raise ValueError("hot_fields come with a hot plane, and only then")
    tensors = [("fields", fields)]
    if hot_fields is not None:
        if hot_fields.dtype != fields.dtype or hot_fields.shape != hot.shape:
            raise ValueError(
                f"hot_fields must be {fields.dtype} {tuple(hot.shape)}, got "
                f"{hot_fields.dtype} {tuple(hot_fields.shape)}"
            )
        tensors.append(("hot_fields", hot_fields))
    if max_fields < 1:
        raise ValueError(f"max_fields must be positive, got {max_fields}")
    check_mvm_slots(keys.shape[1] + (hot.shape[1] if hot is not None else 0))
    for name, t in tensors:
        if t.device != keys.device:
            raise ValueError(f"{name} on {t.device}, keys on {keys.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_hot(keys, hot, hot_x, hot_size: int, table) -> None:
    """Validate a hot plane against the cold plane ``keys`` [B, K] and
    a [T, dim] ``table``: int16 (the u16 bits) or int32 [B, Kh],
    ``hot_x`` float32 [B, Kh] or None, 0 < hot_size <= T (2^15 at most
    for u16 keys, whose padding 0xFFFF must stay out of range)."""
    if hot.dtype not in (torch.int16, torch.int32) or hot.dim() != 2:
        raise ValueError(
            f"hot must be int16 (u16 bits) or int32 [B, Kh], got {hot.dtype} "
            f"{tuple(hot.shape)}"
        )
    if hot.shape[0] != keys.shape[0]:
        raise ValueError(f"hot has {hot.shape[0]} rows, keys {keys.shape[0]}")
    if not 0 < hot_size <= table.shape[0]:
        raise ValueError(f"hot_size {hot_size} outside (0, {table.shape[0]}]")
    if hot.dtype == torch.int16 and hot_size > 1 << 15:
        raise ValueError(f"u16 hot keys need hot_size <= 2^15, got {hot_size}")
    tensors = [("hot", hot)]
    if hot_x is not None:
        if hot_x.dtype != torch.float32 or hot_x.shape != hot.shape:
            raise ValueError(
                f"hot_x must be float32 {tuple(hot.shape)}, got {hot_x.dtype} "
                f"{tuple(hot_x.shape)}"
            )
        tensors.append(("hot_x", hot_x))
    for name, t in tensors:
        if t.device != keys.device:
            raise ValueError(f"{name} on {t.device}, keys on {keys.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_tables(keys, x, w, v, mvm: bool) -> list:
    """Validate the key plane, ``x`` and the tables: ``w`` float32
    [T, 1] (LR, FM; None in the MVM form), ``v`` float32 [T, D] with
    D >= 1 (FM, MVM; None for LR).  Returns [(name, tensor)] for the
    device and contiguity checks."""
    if keys.dtype != torch.int32 or keys.dim() != 2:
        raise ValueError(f"keys must be int32 [B, K], got {keys.dtype} {tuple(keys.shape)}")
    if mvm:
        if w is not None or v is None:
            raise ValueError("the MVM form takes v and no w")
    elif w is None:
        raise ValueError("w must be float32 [T, 1], got None (only MVM has no w)")
    elif w.dtype != torch.float32 or w.dim() != 2 or w.shape[1] != 1:
        raise ValueError(f"w must be float32 [T, 1], got {w.dtype} {tuple(w.shape)}")
    rows = (w if w is not None else v).shape[0]
    if rows > _I32_MAX:
        raise ValueError(f"table of {rows} rows does not fit int32 keys")
    tensors = [("keys", keys)] + ([("w", w)] if w is not None else [])
    if x is not None:
        if x.dtype != torch.float32 or x.shape != keys.shape:
            raise ValueError(
                f"x must be float32 {tuple(keys.shape)}, got {x.dtype} {tuple(x.shape)}"
            )
        tensors.append(("x", x))
    if v is not None:
        if v.dtype != torch.float32 or v.dim() != 2 or v.shape[0] != rows:
            raise ValueError(
                f"v must be float32 [{rows}, D], got {v.dtype} {tuple(v.shape)}"
            )
        if v.shape[1] < 1:
            raise ValueError(f"v width {v.shape[1]} outside [1, inf)")
        tensors.append(("v", v))
    return tensors


def _check(keys, x, w, v, fields) -> None:
    tensors = check_tables(keys, x, w, v, fields is not None)
    for name, t in tensors:
        if t.device != keys.device:
            raise ValueError(f"{name} on {t.device}, keys on {keys.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def hot_plane_keys(hot: torch.Tensor, hot_size: int) -> torch.Tensor:
    """int64 [B, Kh] keys of a hot plane (u16 as its int16 view with
    0xFFFF padding, or int32 with -1), -1 on padding and on keys outside
    [0, hot_size), which the reference's gather gives a zero row and its
    scatter drops."""
    k = hot.long() & 0xFFFF if hot.dtype == torch.int16 else hot.long()
    return torch.where((k >= 0) & (k < hot_size), k, torch.full_like(k, -1))


def plain_view(keys, x, w, v, hot=None, hot_x=None, hot_size=0,
               hot_bf16=False, snap_w=None, snap_v=None, fields=None,
               hot_fields=None):
    """The forward's plain half, step for step the reference's
    ``_expand_wire`` → ``_gather_model_rows`` → ``_model_view``: decode
    the planes (padding → mask 0, key 0), gather the cold rows (padding
    reads row 0 and is masked out) and the hot rows through
    ``hot_gather`` over rows [0, H), hot first.  ``snap_w``/``snap_v``
    [H, D] (the hot inner's window-start head) stand in for the table
    at cold keys < H.  ``fields``/``hot_fields`` (MVM) widen to the
    view's int64 ``slots``, as ``_expand_wire`` widens the u8 plane.
    Returns (rows {"w", "v"} for the tables given, the model's batch
    view {"keys", "vals", "mask"[, "slots"]}, the hot keys [B, Kh] with
    -1 on padding, or None without a hot plane)."""
    mask = (keys >= 0).to(torch.float32)
    ck = torch.clamp(keys, min=0).long()
    view = {"keys": ck, "vals": mask if x is None else x, "mask": mask}
    if fields is not None:
        view["slots"] = fields.long()
    tables = {"w": (w, snap_w), "v": (v, snap_v)}
    rows = {}
    for name, (t, snap) in tables.items():
        if t is None:
            continue
        rows[name] = t[ck]
        if snap is not None:
            h = snap.shape[0]
            in_head = (ck < h)[..., None]
            rows[name] = torch.where(in_head, snap[ck.clamp(max=h - 1)], rows[name])
    if hot is None:
        return rows, view, None
    hk = hot_plane_keys(hot, hot_size)
    hmask = (hk >= 0).to(torch.float32)
    impl, dtype = ("mxu", torch.bfloat16) if hot_bf16 else ("seg", torch.float32)
    b, kh = hk.shape
    for name in rows:
        t = tables[name][0]
        head = hot_gather(t[:hot_size], hk.reshape(-1), dtype=dtype, impl=impl)
        rows[name] = torch.cat([head.reshape(b, kh, -1), rows[name]], dim=1)
    hot_view = {
        "keys": torch.cat([hk.clamp(min=0), ck], dim=1),
        "vals": torch.cat([hmask if hot_x is None else hot_x, view["vals"]], dim=1),
        "mask": torch.cat([hmask, mask], dim=1),
    }
    if fields is not None:
        hot_view["slots"] = torch.cat([hot_fields.long(), view["slots"]], dim=1)
    return rows, hot_view, hk


def plain_model(w, v, fields, max_fields: int):
    """The model a plain version computes: MVM with field planes, else
    LR (no ``v``) or FM of ``v``'s width."""
    from xflow_tpu_torch.models.fm import FMModel
    from xflow_tpu_torch.models.lr import LRModel
    from xflow_tpu_torch.models.mvm import MVMModel

    if fields is not None:
        return MVMModel(v_dim=v.shape[1], max_fields=max_fields)
    return LRModel() if v is None else FMModel(v_dim=v.shape[1])


def score_plain(
    keys: torch.Tensor,
    x: torch.Tensor | None,
    w: torch.Tensor | None,
    v: torch.Tensor | None,
    return_logit: bool = False,
    hot: torch.Tensor | None = None,
    hot_x: torch.Tensor | None = None,
    hot_size: int = 0,
    hot_bf16: bool = False,
    fields: torch.Tensor | None = None,
    hot_fields: torch.Tensor | None = None,
    max_fields: int = 0,
):
    """K1's plain PyTorch version, step for step the reference's
    predict: :func:`plain_view`, the model's logit, the clamp."""
    rows, batch, _ = plain_view(keys, x, w, v, hot, hot_x, hot_size, hot_bf16,
                                fields=fields, hot_fields=hot_fields)
    logit = plain_model(w, v, fields, max_fields).logit(rows, batch)
    pctr = sigmoid_ref(logit)
    return (pctr, logit) if return_logit else pctr


def score(
    keys: torch.Tensor,
    x: torch.Tensor | None,
    w: torch.Tensor | None,
    v: torch.Tensor | None,
    return_logit: bool = False,
    hot: torch.Tensor | None = None,
    hot_x: torch.Tensor | None = None,
    hot_size: int = 0,
    hot_bf16: bool = False,
    fields: torch.Tensor | None = None,
    hot_fields: torch.Tensor | None = None,
    max_fields: int = 0,
):
    """pctr [B] (and the logit [B] with ``return_logit``) for
    sentinel-coded keys [B, K] and, with a hot table, the hot plane
    ``hot`` [B, Kh] (module docstring); ``x``/``hot_x`` None mean x = 1
    on live slots; ``fields`` selects the MVM form.  CPU tensors take
    the plain version; CUDA tensors launch K1."""
    _check(keys, x, w, v, fields)
    if hot is not None:
        check_hot(keys, hot, hot_x, hot_size, w if w is not None else v)
    if fields is not None:
        check_fields(keys, fields, hot, hot_fields, max_fields)
    if keys.device.type == "cpu":
        return score_plain(keys, x, w, v, return_logit, hot, hot_x, hot_size,
                           hot_bf16, fields, hot_fields, max_fields)
    if keys.device.type != "cuda":
        raise ValueError(f"score: unsupported device {keys.device}")
    lib = _lib()
    b, k = keys.shape
    kh = hot.shape[1] if hot is not None else 0
    pctr = torch.empty(b, dtype=torch.float32, device=keys.device)
    logit = torch.empty_like(pctr) if return_logit else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(keys.device):
        rc = lib.xf_score(
            keys.data_ptr(),
            ptr(x),
            ptr(hot) if kh else None,
            ptr(hot_x) if kh else None,
            1 if kh and hot.dtype == torch.int16 else 0,
            hot_size if kh else 0,
            1 if kh and hot_bf16 else 0,
            ptr(fields),
            ptr(hot_fields) if kh else None,
            1 if fields is not None and fields.dtype == torch.int32 else 0,
            max_fields,
            ptr(w),
            ptr(v),
            pctr.data_ptr(),
            ptr(logit),
            b,
            k,
            kh,
            v.shape[1] if v is not None else 0,
            torch.cuda.current_stream(keys.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"score kernel launch failed: CUDA error {rc}")
    score.launches += 1
    return (pctr, logit) if return_logit else pctr


score.launches = 0
