"""ctypes bindings for the native parser (the reference's native/ffi.py
over the port's own build): ``xf_parse_block``, ``xf_pack_batch``,
``xf_dict_encode`` and ``xf_murmur64``.

The library builds at first use (build.py).  As in the reference, a
host that cannot build it degrades: ``available()`` is False and the
callers take the pure-Python parser and numpy packing, which the tests
hold byte-equal to the native results; the trainer's run header names
the parser that ran.  ctypes releases the GIL around each call, so the
loader's parse workers run in parallel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from xflow_tpu_torch.io.batch import Batch, ParsedBlock

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def load_library() -> ctypes.CDLL | None:
    """The bound library, built and loaded once per process; None when
    it cannot build or load here."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            from xflow_tpu_torch.native.build import build_if_needed

            lib = ctypes.CDLL(str(build_if_needed()))
            _bind(lib)
        except (OSError, RuntimeError, AttributeError):
            _load_failed = True
            return None
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64, u64 = ctypes.c_int64, ctypes.c_uint64
    lib.xf_murmur64.restype = u64
    lib.xf_murmur64.argtypes = [ctypes.c_char_p, i64, u64]
    lib.xf_parse_block.restype = i64
    lib.xf_parse_block.argtypes = [
        ctypes.c_char_p, i64,  # data, len
        i64, ctypes.c_int, u64,  # table_size, hash_mode, seed
        f32p, i64,  # labels, max_rows
        i64p, i64p, i32p, f32p,  # row_ptr, keys, slots, vals
        i64, i64p,  # max_nnz, out_nnz
    ]
    lib.xf_dict_encode.restype = i64
    lib.xf_dict_encode.argtypes = [
        i64p, i64, i64, i64p, ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.xf_pack_batch.restype = i64
    lib.xf_pack_batch.argtypes = [
        i64p, f32p, i64p, i32p, f32p,  # row_ptr, labels, keys, slots, vals
        i64, i64, i64,  # start, end, batch_size
        i32p,  # remap (nullable)
        i64, i64, i64,  # hot_size, hot_nnz, cold_nnz
        i32p, i32p, f32p, f32p,  # keys, slots, vals, mask
        i32p, i32p, f32p, f32p,  # hot keys, slots, vals, mask
        f32p, f32p,  # labels, weights
    ]


def available() -> bool:
    return load_library() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _lib_or_raise() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError("the native parser library is not available here")
    return lib


def native_murmur64(data: bytes, seed: int = 0) -> int:
    return int(_lib_or_raise().xf_murmur64(data, len(data), seed))


def native_dict_encode(keys: np.ndarray, dict_cap: int) -> tuple[np.ndarray, np.ndarray]:
    """io/compact.py::dedup_select on the native hash table: the same
    dictionary SET as the numpy path, in another order."""
    lib = _lib_or_raise()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n = len(keys)
    uniq = np.empty(dict_cap, np.int64)
    codes = np.empty(n, np.uint32)
    nd = lib.xf_dict_encode(_ptr(keys, ctypes.c_int64), n, dict_cap,
                            _ptr(uniq, ctypes.c_int64), _ptr(codes, ctypes.c_uint32))
    if nd < 0:
        raise MemoryError("xf_dict_encode: allocation failed")
    return uniq[:nd].copy(), codes


def native_parse_block(data: bytes, table_size: int, hash_mode: bool = True,
                       hash_seed: int = 0) -> ParsedBlock:
    """io/libffm.py::parse_block in C++ (byte-equal results)."""
    lib = _lib_or_raise()
    # keys must survive the int32 batch planes; 0 keeps full 64-bit keys
    if table_size != 0 and not 0 < table_size <= (1 << 31):
        raise ValueError(
            f"table_size {table_size} out of range (0, 2^31] — parsed "
            "keys must fit int32 batch arrays (0 = keep full keys)"
        )
    # capacity bounds: a sample per line, 2 of the block's ':' per token
    max_rows = data.count(b"\n") + 1
    max_nnz = data.count(b":") // 2 + 1
    labels = np.empty(max_rows, dtype=np.float32)
    row_ptr = np.empty(max_rows + 1, dtype=np.int64)
    keys = np.empty(max_nnz, dtype=np.int64)
    slots = np.empty(max_nnz, dtype=np.int32)
    vals = np.empty(max_nnz, dtype=np.float32)
    out_nnz = np.zeros(1, dtype=np.int64)
    n_rows = lib.xf_parse_block(
        data, len(data), table_size, 1 if hash_mode else 0, hash_seed,
        _ptr(labels, ctypes.c_float), max_rows, _ptr(row_ptr, ctypes.c_int64),
        _ptr(keys, ctypes.c_int64), _ptr(slots, ctypes.c_int32),
        _ptr(vals, ctypes.c_float), max_nnz, _ptr(out_nnz, ctypes.c_int64),
    )
    if n_rows < 0:
        raise RuntimeError("native parser capacity overflow (bound bug)")
    nnz = int(out_nnz[0])
    return ParsedBlock(
        labels=labels[:n_rows].copy(),
        row_ptr=row_ptr[: n_rows + 1].copy(),
        keys=keys[:nnz].copy(),
        slots=slots[:nnz].copy(),
        vals=vals[:nnz].copy(),
    )


def native_pack_batch(block: ParsedBlock, start: int, end: int, batch_size: int,
                      max_nnz: int, hot_size: int = 0, hot_nnz: int = 0,
                      remap: np.ndarray | None = None) -> Batch:
    """io/batch.py::pack_batch in C++ (byte-equal results), with the
    frequency remap and the hot steering folded into the one pass.
    ``block`` must hold RAW (un-remapped) keys when ``remap`` is
    given."""
    lib = _lib_or_raise()
    n = end - start
    if not 0 < n <= batch_size:
        raise ValueError(f"pack_batch: {n} samples do not fit batch_size {batch_size}")
    kh = hot_nnz if hot_size else 0
    row_ptr = np.ascontiguousarray(block.row_ptr, dtype=np.int64)
    labels_in = np.ascontiguousarray(block.labels, dtype=np.float32)
    keys_in = np.ascontiguousarray(block.keys, dtype=np.int64)
    slots_in = np.ascontiguousarray(block.slots, dtype=np.int32)
    vals_in = np.ascontiguousarray(block.vals, dtype=np.float32)
    if remap is not None:
        remap = np.ascontiguousarray(remap, dtype=np.int32)
    keys = np.empty((batch_size, max_nnz), np.int32)
    slots = np.empty((batch_size, max_nnz), np.int32)
    vals = np.empty((batch_size, max_nnz), np.float32)
    mask = np.empty((batch_size, max_nnz), np.float32)
    hot_keys = np.empty((batch_size, kh), np.int32)
    hot_slots = np.empty((batch_size, kh), np.int32)
    hot_vals = np.empty((batch_size, kh), np.float32)
    hot_mask = np.empty((batch_size, kh), np.float32)
    labels = np.empty(batch_size, np.float32)
    weights = np.empty(batch_size, np.float32)
    null_i32 = ctypes.POINTER(ctypes.c_int32)()
    rc = lib.xf_pack_batch(
        _ptr(row_ptr, ctypes.c_int64), _ptr(labels_in, ctypes.c_float),
        _ptr(keys_in, ctypes.c_int64), _ptr(slots_in, ctypes.c_int32),
        _ptr(vals_in, ctypes.c_float), start, end, batch_size,
        _ptr(remap, ctypes.c_int32) if remap is not None else null_i32,
        hot_size if kh else 0, kh, max_nnz,
        _ptr(keys, ctypes.c_int32), _ptr(slots, ctypes.c_int32),
        _ptr(vals, ctypes.c_float), _ptr(mask, ctypes.c_float),
        _ptr(hot_keys, ctypes.c_int32), _ptr(hot_slots, ctypes.c_int32),
        _ptr(hot_vals, ctypes.c_float), _ptr(hot_mask, ctypes.c_float),
        _ptr(labels, ctypes.c_float), _ptr(weights, ctypes.c_float),
    )
    if rc == -2:
        raise ValueError(
            "pack_batch: a (remapped) key exceeds int32 — table_size or "
            "remap values too large for the int32 batch arrays"
        )
    if rc < 0:
        raise RuntimeError(f"native pack_batch failed (rc={rc})")
    if not kh:
        return Batch(keys=keys, slots=slots, vals=vals, mask=mask,
                     labels=labels, weights=weights)
    return Batch(keys=keys, slots=slots, vals=vals, mask=mask,
                 labels=labels, weights=weights, hot_keys=hot_keys,
                 hot_slots=hot_slots, hot_vals=hot_vals, hot_mask=hot_mask)
