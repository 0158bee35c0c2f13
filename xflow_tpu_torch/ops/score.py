"""K1, the fused scoring kernel: wrapper, plain version and binding.

``score(keys, x, w, v, form=...)`` returns the clamped-sigmoid pctr
[B] for sentinel-coded keys in one of four forms, named by ``form``:

* ``"lr"``: ``w`` alone;
* ``"fm"``: ``w`` and ``v`` of any width (the kernel runs D in tiles of
  32); ``form=None`` means ``"lr"`` without ``v`` and ``"fm"`` with it;
* ``"mvm"`` (B9): ``v`` and no ``w``;
* ``"ffm"`` (B10): ``w`` and ``v`` [T, F*D], F = ``max_fields``.

The field forms read ``fields`` [B, K] and ``hot_fields`` [B, Kh], the
field ids, uint8 as the compact and dictionary wires ship them or int32
as the full wire does, and ``max_fields``, the F of the reference's
one-hot; a slot whose field lies outside [0, F) is dropped from the
field terms (FFM keeps it in its linear term).  On CUDA tensors it launches
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
(ops/hot.py).  In the FFM form it rounds ``w``'s alone: FFM's ``v``
opts out of the hot table's path (``TableSpec.hot=False``), so its hot
rows are read as they are.  :func:`plain_view` is the forward's plain half, shared
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
# warp's shared memory (csrc/mvm.cuh: MVM_BYTES_PER_SLOT a slot and
# MVM_WARP_BYTES a warp), and a block holds at most MVM_SMEM_BYTES (the
# H100's and H200's opt-in per block): up to MVM_MAX_SLOTS slots.  A
# wider row takes the kernels' device-memory stage (csrc/stage.cuh),
# which the wrapper allocates.
MVM_BYTES_PER_SLOT = 156
MVM_WARP_BYTES = 1152
MVM_SMEM_BYTES = 232_448
MVM_MAX_SLOTS = (MVM_SMEM_BYTES - MVM_WARP_BYTES) // MVM_BYTES_PER_SLOT
# The FFM forms (csrc/ffm.cuh) stage an example's slots (key, x, field,
# gradient row: FFM_BYTES_PER_SLOT each), a block-reduction scratch and
# the field sums S [F, F, Dt] of a tile of Dt factors in one block's
# shared memory.  Dt is the most factors whose stage fits the default
# FFM_TILE_SMEM (at least 1); one factor's stage past MVM_SMEM_BYTES
# (the opt-in per block; F above about 240) takes the device-memory
# stage (ffm_stage_global).
FFM_BYTES_PER_SLOT = 16
FFM_SCRATCH_BYTES = 32 * 4
FFM_TILE_SMEM = 48 * 1024
FORMS = ("lr", "fm", "mvm", "ffm")

_bound: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        from xflow_tpu_torch.ops.build import load_library

        lib = load_library("score")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.xf_score.argtypes = [
            vp, vp, vp, vp, ci, ci, ci,  # keys, x, hot, hot_x, hot_u16, H, bf16
            ci, vp, vp, ci, ci,  # form, fields, hot_fields, f_i32, S
            vp, vp, vp, vp, ci, ci, ci, ci,  # w, v, pctr, logit, B, K, KH, D
            vp, vp,  # the device-memory stage, stream
        ]
        lib.xf_score.restype = ci
        lib.xf_score_stage_bytes.argtypes = [ci] * 6
        lib.xf_score_stage_bytes.restype = ctypes.c_longlong
        check_stage_abi(lib)
        _bound = lib
    return _bound


# the C ABI's form codes (csrc/score.cu, csrc/train.cu)
FORM_CODES = {"lr": 0, "fm": 0, "mvm": 1, "ffm": 2}


def check_stage_abi(lib: ctypes.CDLL) -> None:
    """The library's shared-memory stages must be the ones this module
    picks the form by: MVM_BYTES_PER_SLOT a slot and MVM_WARP_BYTES a
    warp, and FFM's stage and tile as ``ffm_stage_bytes`` and
    ``ffm_tile`` compute them."""
    ci = ctypes.c_int
    for fn, want in (("xf_mvm_bytes_per_slot", MVM_BYTES_PER_SLOT),
                     ("xf_mvm_warp_bytes", MVM_WARP_BYTES)):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ci
        if getattr(lib, fn)() != want:
            raise RuntimeError(f"csrc/mvm.cuh's {fn}() {getattr(lib, fn)()} != "
                               f"ops/score.py's {want}")
    lib.xf_ffm_stage_bytes.argtypes = [ci, ci, ci]
    lib.xf_ffm_stage_bytes.restype = ci
    lib.xf_ffm_tile.argtypes = [ci, ci, ci]
    lib.xf_ffm_tile.restype = ci
    for f, d, n in ((39, 4, 40), (39, 16, 44), (64, 4, 40), (240, 1, 8)):
        if (lib.xf_ffm_stage_bytes(f, n, 1) != ffm_stage_bytes(f, n, 1)
                or lib.xf_ffm_tile(f, d, n) != ffm_tile(f, d, n)):
            raise RuntimeError(
                f"csrc/ffm.cuh's stage at F={f}, D={d}, {n} slots differs from "
                "ops/score.py's ffm_stage_bytes / ffm_tile"
            )


def ffm_stage_bytes(max_fields: int, slots: int, dt: int = 1) -> int:
    """Shared bytes of one FFM block: S [F, F, dt], the slot stage and
    the reduction scratch (csrc/ffm.cuh)."""
    return 4 * max_fields * max_fields * dt + FFM_BYTES_PER_SLOT * slots + FFM_SCRATCH_BYTES


def ffm_tile(max_fields: int, d: int, slots: int) -> int:
    """Factors per tile of the FFM forms: the most (at most D) whose
    stage fits FFM_TILE_SMEM, and at least one (csrc/ffm.cuh)."""
    dt = d
    while dt > 1 and ffm_stage_bytes(max_fields, slots, dt) > FFM_TILE_SMEM:
        dt -= 1
    return dt


def ffm_stage_global(max_fields: int, slots: int) -> bool:
    """Whether an FFM row takes the kernels' device-memory stage: the
    field sums of one factor (4 F^2 B) beside the row's slots pass a
    block's MVM_SMEM_BYTES of shared memory (csrc/ffm.cuh)."""
    return ffm_stage_bytes(max_fields, slots) > MVM_SMEM_BYTES


def mvm_stage_global(slots: int) -> bool:
    """Whether an MVM row takes the kernels' device-memory stage: more
    than MVM_MAX_SLOTS slots (csrc/mvm.cuh)."""
    return slots > MVM_MAX_SLOTS


def field_stage_global(form: str, max_fields: int, slots: int) -> bool:
    """Whether a row of ``slots`` slots (hot + cold) in ``form`` takes
    the device-memory stage (csrc/stage.cuh) rather than shared memory."""
    if form == "mvm":
        return mvm_stage_global(slots)
    return form == "ffm" and ffm_stage_global(max_fields, slots)


def field_stage(stage_bytes, form: str, max_fields: int, b: int, k: int, kh: int,
                d: int, device) -> torch.Tensor | None:
    """The device-memory stage a field form's launch needs (uint8, as
    many bytes as the library's ``stage_bytes`` function gives for the
    shapes), or None where the row stages in shared memory."""
    if not field_stage_global(form, max_fields, k + kh):
        return None
    nbytes = stage_bytes(FORM_CODES[form], max_fields, b, k, kh, d)
    return torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes else None


def resolve_form(form: str | None, v, fields) -> str:
    """The kernel form a call names: ``form`` itself, or without one
    ``"lr"`` (no ``v``) or ``"fm"``; field planes need a field form."""
    if form is None:
        if fields is not None:
            raise ValueError("field planes need form='mvm' or form='ffm'")
        return "lr" if v is None else "fm"
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; one of {FORMS}")
    return form


def check_fields(keys, fields, hot, hot_fields, max_fields: int, form: str) -> None:
    """The field forms' planes: ``fields`` beside ``keys`` (given in the
    MVM and FFM forms, and only then) and ``hot_fields`` beside ``hot``
    (and only with it), uint8 or int32, one dtype, a positive
    ``max_fields``."""
    if (fields is not None) != (form in ("mvm", "ffm")):
        raise ValueError(f"field planes come with the mvm and ffm forms, and "
                         f"only then (form {form!r})")
    if fields is None:
        return
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


def check_tables(keys, x, w, v, form: str, max_fields: int = 0) -> list:
    """Validate the key plane, ``x`` and the tables for ``form``: ``w``
    float32 [T, 1] (LR, FM, FFM; None in the MVM form), ``v`` float32
    [T, D] with D >= 1 (FM, MVM; None for LR), [T, F*D] in the FFM form.
    Returns [(name, tensor)] for the device and contiguity checks."""
    if keys.dtype != torch.int32 or keys.dim() != 2:
        raise ValueError(f"keys must be int32 [B, K], got {keys.dtype} {tuple(keys.shape)}")
    if form == "mvm":
        if w is not None or v is None:
            raise ValueError("the MVM form takes v and no w")
    elif w is None:
        raise ValueError("w must be float32 [T, 1], got None (only MVM has no w)")
    elif (v is None) != (form == "lr"):
        raise ValueError(f"the {form} form takes {'no v' if form == 'lr' else 'v'}")
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
        if form == "ffm" and (max_fields < 1 or v.shape[1] % max_fields):
            raise ValueError(
                f"the FFM form's v is [T, max_fields * D]: width {v.shape[1]} "
                f"with max_fields {max_fields}"
            )
        tensors.append(("v", v))
    return tensors


def _check(keys, x, w, v, form, max_fields) -> None:
    tensors = check_tables(keys, x, w, v, form, max_fields)
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
               hot_fields=None, opted_out=()):
    """The forward's plain half, step for step the reference's
    ``_expand_wire`` → ``_gather_model_rows`` → ``_model_view``: decode
    the planes (padding → mask 0, key 0), gather the cold rows (padding
    reads row 0 and is masked out) and the hot rows through
    ``hot_gather`` over rows [0, H), hot first.  ``snap_w``/``snap_v``
    [H, D] (the hot inner's window-start head) stand in for the table
    at cold keys < H.  ``fields``/``hot_fields`` (MVM, FFM) widen to the
    view's int64 ``slots``, as ``_expand_wire`` widens the u8 plane.
    The tables named in ``opted_out`` (``TableSpec.hot=False``: FFM's v)
    read their hot rows as plain float32 rows, whatever ``hot_bf16``.
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
        if name in opted_out:
            head = hot_gather(t[:hot_size], hk.reshape(-1))
        else:
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


def plain_model(form: str, v, max_fields: int):
    """The model a plain version computes in ``form``, at ``v``'s width."""
    from xflow_tpu_torch.models.ffm import FFMModel
    from xflow_tpu_torch.models.fm import FMModel
    from xflow_tpu_torch.models.lr import LRModel
    from xflow_tpu_torch.models.mvm import MVMModel

    if form == "mvm":
        return MVMModel(v_dim=v.shape[1], max_fields=max_fields)
    if form == "ffm":
        return FFMModel(v_dim=v.shape[1] // max_fields, max_fields=max_fields)
    return LRModel() if form == "lr" else FMModel(v_dim=v.shape[1])


def opted_out_tables(model) -> tuple:
    """The tables of ``model`` that opt out of the hot table's path."""
    return tuple(spec.name for spec in model.tables() if not spec.hot)


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
    form: str | None = None,
):
    """K1's plain PyTorch version, step for step the reference's
    predict: :func:`plain_view`, the model's logit, the clamp."""
    model = plain_model(resolve_form(form, v, fields), v, max_fields)
    rows, batch, _ = plain_view(keys, x, w, v, hot, hot_x, hot_size, hot_bf16,
                                fields=fields, hot_fields=hot_fields,
                                opted_out=opted_out_tables(model))
    logit = model.logit(rows, batch)
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
    form: str | None = None,
):
    """pctr [B] (and the logit [B] with ``return_logit``) for
    sentinel-coded keys [B, K] and, with a hot table, the hot plane
    ``hot`` [B, Kh] (module docstring); ``x``/``hot_x`` None mean x = 1
    on live slots; ``form`` names the model's form (``fields`` come with
    ``"mvm"`` and ``"ffm"``).  CPU tensors take the plain version; CUDA
    tensors launch K1."""
    form = resolve_form(form, v, fields)
    _check(keys, x, w, v, form, max_fields)
    if hot is not None:
        check_hot(keys, hot, hot_x, hot_size, w if w is not None else v)
    check_fields(keys, fields, hot, hot_fields, max_fields, form)
    if keys.device.type == "cpu":
        return score_plain(keys, x, w, v, return_logit, hot, hot_x, hot_size,
                           hot_bf16, fields, hot_fields, max_fields, form)
    if keys.device.type != "cuda":
        raise ValueError(f"score: unsupported device {keys.device}")
    lib = _lib()
    b, k = keys.shape
    kh = hot.shape[1] if hot is not None else 0
    pctr = torch.empty(b, dtype=torch.float32, device=keys.device)
    logit = torch.empty_like(pctr) if return_logit else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    d = v.shape[1] if v is not None else 0
    stage = field_stage(lib.xf_score_stage_bytes, form, max_fields, b, k, kh, d,
                        keys.device)
    with torch.cuda.device(keys.device):
        rc = lib.xf_score(
            keys.data_ptr(),
            ptr(x),
            ptr(hot) if kh else None,
            ptr(hot_x) if kh else None,
            1 if kh and hot.dtype == torch.int16 else 0,
            hot_size if kh else 0,
            1 if kh and hot_bf16 else 0,
            FORM_CODES[form],
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
            d,
            ptr(stage),
            torch.cuda.current_stream(keys.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"score kernel launch failed: CUDA error {rc}")
    score.launches += 1
    return (pctr, logit) if return_logit else pctr


score.launches = 0
