"""The native libffm parser, packer and dictionary encoder (the port's
copy of the reference's native/ package: ``src/parser.cc`` byte-equal,
built by build.py, bound by ffi.py)."""

from xflow_tpu_torch.native.ffi import (
    available,
    native_dict_encode,
    native_murmur64,
    native_pack_batch,
    native_parse_block,
)

__all__ = [
    "available",
    "native_dict_encode",
    "native_murmur64",
    "native_pack_batch",
    "native_parse_block",
]
