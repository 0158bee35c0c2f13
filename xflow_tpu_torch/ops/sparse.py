"""Static-shape sparse primitives (the reference's ops/sparse.py on
tensors) and the wrappers of K4 and K5 (csrc/sparse.cu).

The reference's six functions, as plain tensor functions with its
contract (integer outputs equal, sums to float rounding).  The training
path calls ``consolidate_plan`` (through K4's plain version),
``gather_rows`` and ``scatter_rows`` (through K5's); ``consolidate``,
``consolidate_apply`` and ``consolidate_indexed`` have no caller in the
port and are kept for parity with the reference, held by
tests/test_torch_sparse.py: the dictionary wire's plan feeds only dense
``cold_consolidate``, which the port runs as the plain dense step, so
the port's decode (ops/wire.py) ships none (ROADMAP B5):

* ``consolidate_plan`` / ``consolidate_apply`` / ``consolidate``: a
  stable argsort of the M sentinel-coded keys (padding carries the
  sentinel ``T``), segment starts, cumsum segment ids; ``ukeys`` [M]
  holds the unique keys in sorted order and the sentinel ``T`` in the
  unused slots; the per-table segment-sum of [M, D] gradients.
* ``consolidate_indexed``: the segment-sum over a host-computed index
  (the dictionary wire's plan).
* ``gather_rows`` (the index clipped) and ``scatter_rows`` (sentinel
  rows dropped).  ``scatter_rows`` writes IN PLACE, where the reference
  returns a new array; it needs the live keys unique, as every
  consolidated ``ukeys`` is.

The kernels, one wrapper each, with a plain version beside it:

* K4 ``consolidate_keys`` (B5's plan): the keys' distinct live keys
  into ``ukeys``, their number into ``count`` (on the device: it never
  reaches the host), and each occurrence's slot into ``slots`` (-1 on
  padding), so that K2's index mode (ops/train.py) sums the gradients
  per unique key.  The kernel gives the slots in no particular order
  (csrc/sparse.cu): one launch up to ``K4_SLICE_MAX`` keys (a
  cooperative grid), three device operations past it; the plain version
  is ``consolidate_plan``, so it gives the reference's sorted order, and
  is free of host syncs.
* K5 ``touched_update`` (B6 with B3's recurrence): FTRL or SGD in
  place on the rows ``ukeys[:count]`` of one table or of every table of
  an update in ONE launch, with the summed gradients ``gsum``.  It
  clears ``gsum[:count]`` and, given the slot map, resets the map at
  those keys.  The plain version is the reference's per-table loop,
  gather_rows → ``update_rows`` → scatter_rows for each table.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise: there is no fallback.  ``consolidate_keys.launches`` and
``touched_update.launches`` count wrapper calls that launched a kernel
(a K5 call is one launch, whatever its number of tables).
"""

from __future__ import annotations

import ctypes

import torch

from xflow_tpu_torch.optim import FTRL, SGD

_bound: ctypes.CDLL | None = None
# K4's slice form (csrc/sparse.cu kSliceMax): one launch up to this many
# keys, the batch form's three device operations past it
K4_SLICE_MAX = 32_768
# the most tables one K5 launch steps (csrc/sparse.cu kMaxTables)
K5_MAX_TABLES = 4


def consolidate_plan(keys: torch.Tensor, table_size: int):
    """The key-only half of ``consolidate``, computed once and shared by
    a model's tables: (order [M], seg [M], ukeys [M]) for int32 keys [M]
    whose padding carries the sentinel ``table_size``."""
    m = keys.shape[0]
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    is_start = torch.ones(m, dtype=torch.bool, device=keys.device)
    is_start[1:] = sk[1:] != sk[:-1]
    seg = torch.cumsum(is_start, 0) - 1
    ukeys = torch.full((m,), table_size, dtype=torch.int32, device=keys.device)
    # every element of a segment carries the segment's key, so a plain
    # scatter of all of them writes each slot with one value
    ukeys.index_copy_(0, seg, sk.to(torch.int32))
    return order, seg, ukeys


def consolidate_apply(grads: torch.Tensor, order: torch.Tensor,
                      seg: torch.Tensor) -> torch.Tensor:
    """Per-table half: gradients [M, D] permuted into key order and
    segment-summed; slot i pairs with the plan's ``ukeys[i]``."""
    sg = grads[order]
    out = torch.zeros_like(grads)
    return out.index_add_(0, seg, sg)


def consolidate(keys: torch.Tensor, grads: torch.Tensor, table_size: int):
    """(ukeys [M], gsum [M, D]): the unique keys in sorted order with
    their summed gradients; unused slots hold the sentinel and g = 0."""
    order, seg, ukeys = consolidate_plan(keys, table_size)
    return ukeys, consolidate_apply(grads, order, seg)


def consolidate_indexed(grads: torch.Tensor, uidx: torch.Tensor,
                        num_slots: int) -> torch.Tensor:
    """Sum [M, D] gradients into ``num_slots`` slots by a host-computed
    index; entries with ``uidx == num_slots`` are dropped."""
    out = torch.zeros((num_slots + 1, grads.shape[1]), dtype=grads.dtype,
                      device=grads.device)
    out.index_add_(0, uidx.long().clamp(0, num_slots), grads)
    return out[:num_slots]


def gather_rows(table: torch.Tensor, ukeys: torch.Tensor) -> torch.Tensor:
    """Rows [U, D] at ``ukeys``; out-of-range (sentinel) keys clip to the
    nearest row."""
    return table[ukeys.long().clamp(0, table.shape[0] - 1)]


def scatter_rows(table: torch.Tensor, ukeys: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """Write ``rows`` at ``ukeys`` in place, dropping out-of-range
    (sentinel) keys, and return ``table``.  Without a host sync: a
    dropped slot rewrites the first live slot's row with that slot's own
    new value (or, when no slot is live, that row's old value), so
    duplicate writes always carry one value."""
    if ukeys.numel() == 0:
        return table
    t = table.shape[0]
    live = (ukeys >= 0) & (ukeys < t)
    idx = ukeys.long().clamp(0, t - 1)
    # the first live slot, else 0, as a [1] index (a 0-d index would
    # read the value back to the host)
    j = torch.argmax(live.to(torch.uint8)).reshape(1)
    fill_idx = idx.index_select(0, j)
    fill_val = torch.where(live.index_select(0, j)[:, None],
                           rows.index_select(0, j), table.index_select(0, fill_idx))
    table.index_copy_(
        0, torch.where(live, idx, fill_idx),
        torch.where(live[:, None], rows, fill_val),
    )
    return table


# -- K4 -------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        from xflow_tpu_torch.ops.build import load_library

        lib = load_library("sparse")
        vp, ll, ci, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.xf_consolidate.argtypes = [vp, ll, ci, vp, vp, vp, vp, vp]
        lib.xf_touched.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, ll, f, f, f, f,
                                   f, vp, ci, vp]
        for fn in (lib.xf_consolidate, lib.xf_touched):
            fn.restype = ci
        lib.xf_consolidate_slice_max.argtypes = []
        lib.xf_consolidate_slice_max.restype = ll
        if lib.xf_consolidate_slice_max() != K4_SLICE_MAX:
            raise RuntimeError("csrc/sparse.cu's kSliceMax differs from ops/sparse.py's "
                               "K4_SLICE_MAX")
        _bound = lib
    return _bound


def _need(name: str, t: torch.Tensor, dtype, dev) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_plan(keys, table_size, ukeys, count, slots, slot_map) -> None:
    dev = keys.device
    for name, t in (("keys", keys), ("ukeys", ukeys), ("count", count),
                    ("slots", slots)):
        _need(name, t, torch.int32, dev)
    if not 0 < table_size < 2**31:
        raise ValueError(f"table of {table_size} rows does not fit int32 keys")
    if slots.shape != keys.shape:
        raise ValueError(f"slots must be {tuple(keys.shape)}, got {tuple(slots.shape)}")
    if ukeys.dim() != 1 or ukeys.numel() < keys.numel():
        raise ValueError(f"ukeys must be [>= {keys.numel()}], got {tuple(ukeys.shape)}")
    if count.shape != (1,):
        raise ValueError(f"count must be [1], got {tuple(count.shape)}")
    if slot_map is not None:
        _need("slot_map", slot_map, torch.int32, dev)
        if slot_map.shape != (table_size,):
            raise ValueError(f"slot_map must be [{table_size}], got {tuple(slot_map.shape)}")


def consolidate_keys_plain(keys, table_size, ukeys, count, slots) -> None:
    """K4's plain version: ``consolidate_plan`` over the keys with every
    padding key (< 0 or >= T) made the sentinel; ``ukeys`` gets the
    plan's sorted unique keys (the sentinel past ``count``), each
    occurrence its segment id, padding -1."""
    flat = keys.reshape(-1).long()
    m = flat.numel()
    pad = (flat < 0) | (flat >= table_size)
    eff = torch.where(pad, torch.full_like(flat, table_size), flat)
    order, seg, uk = consolidate_plan(eff, table_size)
    ukeys[:m] = uk
    ukeys[m:] = table_size
    count.copy_((uk < table_size).sum().to(torch.int32).reshape(1))
    slot = torch.empty_like(seg).index_copy_(0, order, seg)
    slots.copy_(torch.where(pad, torch.full_like(slot, -1), slot).view_as(slots))


def consolidate_keys(keys, table_size, ukeys, count, slots, slot_map=None) -> None:
    """Fill ``ukeys`` [>= M], ``count`` [1] and ``slots`` (keys' shape)
    for the int32 ``keys`` of a table of ``table_size`` rows.  CPU
    tensors take the plain version; CUDA tensors launch K4 (one launch
    up to ``K4_SLICE_MAX`` keys, three device operations past it), which
    needs ``slot_map`` int32 [T] holding -1 everywhere (K5 restores
    it)."""
    _check_plan(keys, table_size, ukeys, count, slots, slot_map)
    dev = keys.device
    if dev.type == "cpu":
        consolidate_keys_plain(keys, table_size, ukeys, count, slots)
        return
    if dev.type != "cuda":
        raise ValueError(f"consolidate_keys: unsupported device {dev}")
    if slot_map is None:
        raise ValueError("consolidate_keys: the kernel needs the slot map")
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.xf_consolidate(
            keys.data_ptr(), keys.numel(), table_size, slot_map.data_ptr(),
            ukeys.data_ptr(), count.data_ptr(), slots.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"consolidate kernel launch failed: CUDA error {rc}")
    consolidate_keys.launches += 1


consolidate_keys.launches = 0


# -- K5 -------------------------------------------------------------------

def _names(opt) -> tuple[str, ...]:
    if isinstance(opt, FTRL):
        return ("param", "n", "z")
    if isinstance(opt, SGD):
        return ("param",)
    raise ValueError(f"touched_update: unsupported optimizer {opt!r}")


def _check_touched(table, opt, ukeys, count, gsum, slot_map, head=None,
                   hot_size=0) -> list[torch.Tensor]:
    names = _names(opt)
    missing = [name for name in names if name not in table]
    if missing:
        raise ValueError(f"touched_update: the table has no {missing}")
    tensors = [table[name] for name in names]
    ref = tensors[0]
    if ref.dim() != 2:
        raise ValueError(f"{names[0]} must be [T, D], got {tuple(ref.shape)}")
    for name, t in zip(names, tensors):
        _need(name, t, torch.float32, ref.device)
        if t.shape != ref.shape:
            raise ValueError(f"{name} must be {tuple(ref.shape)}, got {tuple(t.shape)}")
    _need("gsum", gsum, torch.float32, ref.device)
    if gsum.dim() != 2 or gsum.shape[1] != ref.shape[1]:
        raise ValueError(f"gsum must be [M, {ref.shape[1]}], got {tuple(gsum.shape)}")
    _need("ukeys", ukeys, torch.int32, ref.device)
    if ukeys.dim() != 1 or ukeys.numel() < gsum.shape[0]:
        raise ValueError(f"ukeys must be [>= {gsum.shape[0]}], got {tuple(ukeys.shape)}")
    _need("count", count, torch.int32, ref.device)
    if count.shape != (1,):
        raise ValueError(f"count must be [1], got {tuple(count.shape)}")
    if slot_map is not None:
        _need("slot_map", slot_map, torch.int32, ref.device)
        if slot_map.shape != (ref.shape[0],):
            raise ValueError(f"slot_map must be [{ref.shape[0]}]")
    if head is not None:
        _need("head", head, torch.float32, ref.device)
        if not 0 < hot_size <= ref.shape[0] or head.shape != (hot_size, ref.shape[1]):
            raise ValueError(
                f"head must be [hot_size, {ref.shape[1]}] with 0 < hot_size <= "
                f"{ref.shape[0]}, got {tuple(head.shape)} and {hot_size}"
            )
    return tensors


def _as_list(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def touched_plain(table, opt, ukeys, count, gsum, head=None, hot_size=0) -> None:
    """K5's plain version (the reference's ``_apply_touched_rows``, once
    per table, step.py:1143-1156): ``table``, ``gsum`` and ``head`` are
    one table's or lists of them, one entry a table.  For each: the
    slots past ``count`` made the sentinel, gather_rows →
    ``update_rows`` → scatter_rows, in place; then ``gsum[:count] =
    0``.  With ``head``, the reference's hybrid fold
    (step.py:1194-1238): the sums of keys < H are added into ``head``
    and those keys made the sentinel."""
    heads = _as_list(head) if head is not None else None
    for k, (tab, g) in enumerate(zip(_as_list(table), _as_list(gsum))):
        _touched_one(tab, opt, ukeys, count, g, heads[k] if heads else None, hot_size)


def _touched_one(table, opt, ukeys, count, gsum, head, hot_size) -> None:
    names = _names(opt)
    t = table[names[0]].shape[0]
    cap = gsum.shape[0]
    valid = torch.arange(cap, device=gsum.device) < count
    keys = torch.where(valid, ukeys[:cap], torch.full_like(ukeys[:cap], t))
    if head is not None:
        in_hot = keys < hot_size
        fold = torch.zeros((hot_size + 1, gsum.shape[1]), device=gsum.device)
        fold.index_add_(0, torch.where(in_hot, keys, torch.full_like(keys, hot_size)).long(),
                        gsum)
        head += fold[:hot_size]
        keys = torch.where(in_hot, torch.full_like(keys, t), keys)
    new = opt.update_rows({k: gather_rows(table[k], keys) for k in names}, gsum)
    for name in names:
        scatter_rows(table[name], keys, new[name])
    gsum.masked_fill_(valid[:, None], 0.0)


def touched_update(table, opt, ukeys, count, gsum, slot_map=None, head=None,
                   hot_size=0) -> None:
    """Apply ``opt`` (FTRL or SGD) in place to the rows ``ukeys[:count]``
    of ``table`` (``{"param", <aux>...}``) with ``gsum`` [M, D], or of
    every table of a list (at most ``K5_MAX_TABLES``) with the list
    ``gsum`` beside it, in one launch; clears ``gsum[:count]`` and,
    given ``slot_map``, resets it at those keys.  With ``head``
    [hot_size, D] (a list beside a list of tables), keys < hot_size
    fold into it instead of stepping (module docstring).  CPU tensors
    take the plain version (no slot map there); CUDA tensors launch
    K5."""
    tabs, gsums = _as_list(table), _as_list(gsum)
    heads = _as_list(head) if head is not None else [None] * len(tabs)
    if not 0 < len(tabs) <= K5_MAX_TABLES or len(gsums) != len(tabs) \
            or len(heads) != len(tabs):
        raise ValueError(f"touched_update: 1 to {K5_MAX_TABLES} tables, each with its "
                         f"gsum (and head), got {len(tabs)}, {len(gsums)}, {len(heads)}")
    per = [_check_touched(t, opt, ukeys, count, g, slot_map, h, hot_size)
           for t, g, h in zip(tabs, gsums, heads)]
    dev = per[0][0].device
    if any(ts[0].device != dev for ts in per):
        raise ValueError("touched_update: the tables lie on different devices")
    if len({g.shape[0] for g in gsums}) != 1:
        raise ValueError("touched_update: every gsum must have the same rows")
    if len({h is None for h in heads}) != 1:
        raise ValueError("touched_update: a head buffer for every table, or none")
    if dev.type == "cpu":
        touched_plain(table, opt, ukeys, count, gsum, head, hot_size)
        return
    if dev.type != "cuda":
        raise ValueError(f"touched_update: unsupported device {dev}")
    lib = _lib()
    n = len(tabs)
    ptrs = ctypes.c_void_p * n
    ftrl = isinstance(opt, FTRL)

    def arr(tensors):
        return ptrs(*[t.data_ptr() for t in tensors])

    w = arr([ts[0] for ts in per])
    nn = arr([ts[1] for ts in per]) if ftrl else None
    z = arr([ts[2] for ts in per]) if ftrl else None
    heads_p = arr(heads) if heads[0] is not None else None
    dims = (ctypes.c_int * n)(*[g.shape[1] for g in gsums])
    with torch.cuda.device(dev):
        rc = lib.xf_touched(
            0 if ftrl else 1, n, w, nn, z, arr(gsums), heads_p, dims,
            ukeys.data_ptr(), count.data_ptr(), gsums[0].shape[0],
            opt.alpha if ftrl else 1.0, opt.beta if ftrl else 0.0,
            opt.lambda1 if ftrl else 0.0, opt.lambda2 if ftrl else 0.0,
            0.0 if ftrl else opt.lr,
            slot_map.data_ptr() if slot_map is not None else None,
            hot_size if heads_p is not None else 0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"touched-rows kernel launch failed: CUDA error {rc}")
    touched_update.launches += 1


touched_update.launches = 0
