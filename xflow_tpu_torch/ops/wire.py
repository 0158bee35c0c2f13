"""The dictionary-wire decode, K6 (csrc/wire.cu), and its plain version.

``dict_decode`` turns the planes of io/compact.py::CompactBatch.wire,
on the device, into the compact wire's planes that K1 and K2 read:
``ckeys`` int32 [B, K] with -1 on padding, ``labels_u8`` and
``weights_u8`` [B], and with a hot table (``hot_nnz`` > 0, the
``cw_h*`` planes) the hot plane ``hot`` int32 [B, Kh] with -1 on
padding, and for a model that reads field ids (MVM: the ``cw_cs`` and
``cw_hs`` streams ship) the field planes ``fields`` uint8 [B, K] and
``hot_fields`` uint8 [B, Kh], 0 on padding (the u8 ids as the host
clamped them; K1 and K2 read them at 1 B a slot).  It replaces the
reference's ``TrainStep._expand_dict_wire`` (parallel/step.py:621-766,
ROADMAP B4 dict, its hot tiers and B4s's ``flat_slots``).
``to_device`` ships the numpy planes: the u16 and u32 planes go as
int16 and int32 views of the same bits, since the kernel reads them by
their bytes.

CPU tensors take ``dict_decode_plain`` (a torch transcription of the
reference's decode, free of host syncs); CUDA tensors launch K6 or
raise: there is no fallback.  ``dict_decode.launches`` counts wrapper
calls that launched the kernel (two launches each: the scans, then the
decode).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_bound: ctypes.CDLL | None = None
# the cold planes K6 reads; cw_cun (the real dictionary size) rides the
# wire too, and the decode does not need it
PLANES = ("cw_cc", "cw_cf", "cw_ci", "cw_cu", "cw_ct", "cw_lb", "cw_wb")
# the hot tiers: per-row counts, the tier bitmap (1 = u8), the u8 ids,
# the large tier (u16, or u12's u8 lows) and u12's nibble highs
HOT_PLANES = ("cw_hc", "cw_hf", "cw_h8", "cw_hx", "cw_hxh")
# the field-id streams (u8, flat, row-major): cold, and hot with the
# hot tiers
FIELD_PLANES = ("cw_cs", "cw_hs")


def to_device(wire: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """The numpy wire planes as tensors on ``device`` (u16 → int16 and
    u32 → int32 bit views: the same bytes)."""
    out = {}
    for name, a in wire.items():
        # a packed shard's planes are read-only views of its mmap, which
        # torch does not wrap: those are copied
        a = np.require(a, requirements=("C", "W"))
        if a.dtype == np.uint16:
            a = a.view(np.int16)
        elif a.dtype == np.uint32:
            a = a.view(np.int32)
        out[name] = torch.from_numpy(a).to(device)
    return out


def _bits(plane: torch.Tensor, n: int) -> torch.Tensor:
    """Bits [0, n) of an LSB-first u8 bitmap, as int64."""
    i = torch.arange(n, device=plane.device)
    return (plane.long()[i >> 3] >> (i & 7)) & 1


def _keys(plane: torch.Tensor) -> torch.Tensor:
    """A key plane as int64: u32 (an int32 view), or u24 as [n, 3]
    little-endian bytes."""
    if plane.dim() == 1:
        return plane.long()
    p = plane.long()
    return p[:, 0] | (p[:, 1] << 8) | (p[:, 2] << 16)


def _hot_plain(wire: dict[str, torch.Tensor], kh: int) -> torch.Tensor:
    """The hot half of the reference's decode (step.py:744-766): int32
    [B, kh] hot ids, -1 past each row's count."""
    hc = wire["cw_hc"].long()
    dev = hc.device
    b = hc.shape[0]
    colj = torch.arange(kh, device=dev)[None, :]
    valid = colj < hc[:, None]
    ids = torch.zeros((b, kh), dtype=torch.long, device=dev)
    cap = wire["cw_hf"].shape[0] * 8
    if cap:
        hxh = wire["cw_hxh"].long()
        hx = wire["cw_hx"].long() & 0xFFFF
        if hxh.shape[0]:  # u12 tier: u8 lows + nibble highs
            hi = torch.stack([hxh & 0xF, hxh >> 4], dim=1).reshape(-1)[: hx.shape[0]]
            hx = hx | (hi << 8)
        e = ((torch.cumsum(hc, 0) - hc)[:, None] + colj).clamp(0, cap - 1)
        f = _bits(wire["cw_hf"], cap)
        a_pos = torch.cumsum(f, 0) - 1
        b_pos = torch.cumsum(1 - f, 0) - 1
        h8 = wire["cw_h8"].long()
        zeros = torch.zeros((b, kh), dtype=torch.long, device=dev)
        av = h8[a_pos[e].clamp(0, h8.shape[0] - 1)] if h8.shape[0] else zeros
        bv = hx[b_pos[e].clamp(0, hx.shape[0] - 1)] if hx.shape[0] else zeros
        ids = torch.where(f[e] == 1, av, bv)
    return torch.where(valid, ids, torch.full_like(ids, -1)).to(torch.int32)


def _flat_fields(plane: torch.Tensor, counts: torch.Tensor, width: int) -> torch.Tensor:
    """The reference's ``flat_slots`` (step.py:691-701): a flat u8
    stream gathered at each row's start (the cumsum of the counts) into
    uint8 [B, width], 0 past each row's count, entries clipped to the
    stream's capacity."""
    counts = counts.long()
    b = counts.shape[0]
    colj = torch.arange(width, device=counts.device)[None, :]
    cap = plane.shape[0]
    if cap == 0:
        return torch.zeros((b, width), dtype=torch.uint8, device=counts.device)
    e = ((torch.cumsum(counts, 0) - counts)[:, None] + colj).clamp(0, cap - 1)
    return torch.where(colj < counts[:, None], plane[e], torch.zeros_like(plane[e]))


def _outputs(planes: list, fields) -> tuple:
    """(ckeys, labels, weights[, hot][, fields[, hot_fields]])."""
    if fields is not None:
        planes += [f for f in fields if f is not None]
    return tuple(planes)


def dict_decode_plain(wire: dict[str, torch.Tensor], max_nnz: int, hot_nnz: int = 0):
    """K6's plain version: the reference's ``_expand_dict_wire``
    (step.py:636-766) on tensors, with its clipping.  Returns (ckeys
    int32 [B, K], labels_u8 [B], weights_u8 [B]), the hot plane int32
    [B, hot_nnz] after them when ``hot_nnz`` > 0, and when the field
    streams ship, the field planes uint8 [B, K] (and [B, hot_nnz])
    last."""
    cc = wire["cw_cc"].long()
    dev = cc.device
    b, k = cc.shape[0], max_nnz
    colj = torch.arange(k, device=dev)[None, :]
    entry = (torch.cumsum(cc, 0) - cc)[:, None] + colj
    valid = colj < cc[:, None]
    cap = wire["cw_cf"].shape[0] * 8
    keys = torch.zeros((b, k), dtype=torch.long, device=dev)
    if cap:
        e = entry.clamp(0, cap - 1)
        f = _bits(wire["cw_cf"], cap)
        a_pos = torch.cumsum(f, 0) - 1
        b_pos = torch.cumsum(1 - f, 0) - 1
        fe = f[e]
        ci = wire["cw_ci"].long() & 0xFFFF
        tail = _keys(wire["cw_ct"])
        cu = _keys(wire["cw_cu"])
        cap_a, cap_b, cap_d = ci.shape[0], tail.shape[0], cu.shape[0]
        zeros = torch.zeros((b, k), dtype=torch.long, device=dev)
        av = ci[a_pos[e].clamp(0, cap_a - 1)] if cap_a else zeros
        bv = tail[b_pos[e].clamp(0, cap_b - 1)] if cap_b else zeros
        is_dict = valid & (fe == 1)
        is_tail = valid & (fe == 0)
        dict_keys = cu[av.clamp(0, cap_d - 1)] if cap_d else zeros
        keys = torch.where(is_dict, dict_keys, torch.where(is_tail, bv, zeros))
    ckeys = torch.where(valid, keys, torch.full_like(keys, -1)).to(torch.int32)
    labels = _bits(wire["cw_lb"], b).to(torch.uint8)
    weights = _bits(wire["cw_wb"], b).to(torch.uint8)
    planes = [ckeys, labels, weights]
    if hot_nnz:
        planes.append(_hot_plain(wire, hot_nnz))
    fields = None
    if "cw_cs" in wire:
        fields = (_flat_fields(wire["cw_cs"], wire["cw_cc"], k),
                  _flat_fields(wire["cw_hs"], wire["cw_hc"], hot_nnz) if hot_nnz else None)
    return _outputs(planes, fields)


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        from xflow_tpu_torch.ops.build import load_library

        lib = load_library("wire")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.xf_dict_decode.argtypes = [
            vp, ci, ci,  # cc, b, k
            vp, ll,  # cf, cf_bytes
            vp, ci, vp, ci, vp, ci, ci,  # ci, cap_i, cu, cap_d, ct, cap_t, key_bytes
            vp, vp,  # lb, wb
            vp, vp,  # row_start, word_prefix
            vp, vp, vp,  # ckeys, labels, weights
            ci, vp, vp, ll,  # kh, hc, hf, hf_bytes
            vp, ci, vp, ci, ci, vp, ci,  # h8, cap8, hx, capx, hx_u16, hxh, caph
            vp, vp, vp,  # hot_row_start, hot_prefix, hot
            vp, ci, vp, vp, ci, vp,  # cs, cap_cs, fields, hs, cap_hs, hot_fields
            vp,  # stream
        ]
        lib.xf_dict_decode.restype = ci
        _bound = lib
    return _bound


def _check(wire: dict[str, torch.Tensor], max_nnz: int, hot_nnz: int) -> int:
    """Validate the planes; returns the key width in bytes (3 or 4)."""
    planes = PLANES + (HOT_PLANES if hot_nnz else ())
    missing = [p for p in planes if p not in wire]
    if missing:
        raise ValueError(f"dict_decode: the wire has no {missing}")
    dev = wire["cw_cc"].device
    b = wire["cw_cc"].shape[0]
    for name in planes:
        t = wire[name]
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    u8 = ("cw_cc", "cw_cf", "cw_lb", "cw_wb")
    if "cw_cs" in wire:
        streams = FIELD_PLANES if hot_nnz else FIELD_PLANES[:1]
        missing = [p for p in streams if p not in wire]
        if missing:
            raise ValueError(f"dict_decode: the wire has no {missing}")
        for name in streams:
            if wire[name].device != dev or not wire[name].is_contiguous():
                raise ValueError(f"{name} must be contiguous on {dev}")
        u8 += streams
    if hot_nnz:
        u8 += ("cw_hc", "cw_hf", "cw_h8", "cw_hxh")
        if wire["cw_hc"].shape[0] != b:
            raise ValueError(f"cw_hc must hold {b} counts")
        if wire["cw_hx"].dtype not in (torch.uint8, torch.int16) or wire["cw_hx"].dim() != 1:
            raise ValueError("cw_hx must be u8 (u12 lows) or the int16 view of u16 ids")
        if wire["cw_hx"].dtype == torch.int16 and wire["cw_hxh"].shape[0]:
            raise ValueError("u16 hot ids carry no nibble plane")
        if not 0 < hot_nnz <= 255:
            raise ValueError(f"hot_nnz {hot_nnz} must lie in [1, 255] (u8 counts)")
        if b * hot_nnz >= 2**31:
            raise ValueError(f"{b} x {hot_nnz} hot entries overflow int32 indices")
    for name in u8:
        t = wire[name]
        if t.dtype != torch.uint8 or t.dim() != 1:
            raise ValueError(f"{name} must be uint8 [n], got {t.dtype} {tuple(t.shape)}")
    if wire["cw_lb"].shape[0] != (b + 7) // 8 or wire["cw_wb"].shape[0] != (b + 7) // 8:
        raise ValueError(f"cw_lb and cw_wb must hold {(b + 7) // 8} bytes for {b} rows")
    if wire["cw_ci"].dtype != torch.int16 or wire["cw_ci"].dim() != 1:
        raise ValueError("cw_ci must be the int16 view of the u16 indices")
    widths = set()
    for name in ("cw_cu", "cw_ct"):
        t = wire[name]
        if t.dtype == torch.uint8 and t.dim() == 2 and t.shape[1] == 3:
            widths.add(3)
        elif t.dtype == torch.int32 and t.dim() == 1:
            widths.add(4)
        else:
            raise ValueError(f"{name} must be u24 [n, 3] uint8 or the int32 view "
                             f"of u32 [n], got {t.dtype} {tuple(t.shape)}")
    if len(widths) != 1:
        raise ValueError("cw_cu and cw_ct must share one key width")
    if not 0 < max_nnz <= 255:
        raise ValueError(f"max_nnz {max_nnz} must lie in [1, 255] (u8 counts)")
    if b * max_nnz >= 2**31:
        raise ValueError(f"{b} x {max_nnz} entries overflow int32 indices")
    return widths.pop()


def dict_decode(wire: dict[str, torch.Tensor], max_nnz: int, hot_nnz: int = 0):
    """(ckeys int32 [B, K], labels_u8 [B], weights_u8 [B]) from the
    dictionary-wire planes ``wire`` (``to_device``'s tensors), after
    them the hot plane int32 [B, hot_nnz] (-1 on padding) when
    ``hot_nnz`` > 0, and last, when the field streams ship, the field
    planes uint8 [B, K] and [B, hot_nnz] (0 on padding).  CPU tensors
    take the plain version; CUDA tensors launch K6."""
    key_bytes = _check(wire, max_nnz, hot_nnz)
    cc = wire["cw_cc"]
    dev = cc.device
    if dev.type == "cpu":
        return dict_decode_plain(wire, max_nnz, hot_nnz)
    if dev.type != "cuda":
        raise ValueError(f"dict_decode: unsupported device {dev}")
    b = cc.shape[0]
    cf = wire["cw_cf"]
    ckeys = torch.empty((b, max_nnz), dtype=torch.int32, device=dev)
    labels = torch.empty(b, dtype=torch.uint8, device=dev)
    weights = torch.empty(b, dtype=torch.uint8, device=dev)
    row_start = torch.empty(b, dtype=torch.int32, device=dev)
    word_prefix = torch.empty((cf.shape[0] + 3) // 4, dtype=torch.int32, device=dev)
    kh = hot_nnz
    if kh:
        hf, hx = wire["cw_hf"], wire["cw_hx"]
        hot = torch.empty((b, kh), dtype=torch.int32, device=dev)
        hot_row_start = torch.empty(b, dtype=torch.int32, device=dev)
        hot_prefix = torch.empty((hf.shape[0] + 3) // 4, dtype=torch.int32, device=dev)
        hot_args = (
            kh, wire["cw_hc"].data_ptr(), hf.data_ptr(), hf.shape[0],
            wire["cw_h8"].data_ptr(), wire["cw_h8"].shape[0],
            hx.data_ptr(), hx.shape[0], 1 if hx.dtype == torch.int16 else 0,
            wire["cw_hxh"].data_ptr(), wire["cw_hxh"].shape[0],
            hot_row_start.data_ptr(), hot_prefix.data_ptr(), hot.data_ptr(),
        )
    else:
        hot_args = (0, None, None, 0, None, 0, None, 0, 0, None, 0, None, None, None)
    fields = None
    field_args = (None, 0, None, None, 0, None)
    if "cw_cs" in wire:
        cs = wire["cw_cs"]
        fields = (torch.empty((b, max_nnz), dtype=torch.uint8, device=dev),
                  torch.empty((b, kh), dtype=torch.uint8, device=dev) if kh else None)
        hs = wire["cw_hs"] if kh else None
        field_args = (cs.data_ptr(), cs.shape[0], fields[0].data_ptr(),
                      hs.data_ptr() if kh else None, hs.shape[0] if kh else 0,
                      fields[1].data_ptr() if kh else None)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.xf_dict_decode(
            cc.data_ptr(), b, max_nnz, cf.data_ptr(), cf.shape[0],
            wire["cw_ci"].data_ptr(), wire["cw_ci"].shape[0],
            wire["cw_cu"].data_ptr(), wire["cw_cu"].shape[0],
            wire["cw_ct"].data_ptr(), wire["cw_ct"].shape[0], key_bytes,
            wire["cw_lb"].data_ptr(), wire["cw_wb"].data_ptr(),
            row_start.data_ptr(), word_prefix.data_ptr(),
            ckeys.data_ptr(), labels.data_ptr(), weights.data_ptr(),
            *hot_args,
            *field_args,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"dictionary-wire decode launch failed: CUDA error {rc}")
    dict_decode.launches += 1
    planes = [ckeys, labels, weights] + ([hot] if kh else [])
    return _outputs(planes, fields)


dict_decode.launches = 0
