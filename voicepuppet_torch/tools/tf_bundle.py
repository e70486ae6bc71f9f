"""Pure-numpy readers and writer for TensorFlow's binary weight formats.

Own copy of ``voicepuppet_tpu/tools/tf_bundle.py`` (:54-712), so that the
port reads the reference's released weights with no TensorFlow and
nothing of the JAX package:

  * **V2 TensorBundle checkpoints** (``<prefix>.index`` +
    ``<prefix>.data-NNNNN-of-MMMMM``): the trained ``ckpt_bfmnet/
    bfmnet-65000`` and ``ckpt_pixrefer/pixrefernet-20000`` that the
    reference's ``infer_bfmvid.py`` restores;
  * **V1 single-file checkpoints** (the 2016 slim releases);
  * **frozen GraphDefs**, whose weights live in ``Const`` nodes: the
    Deep3DFace R-Net ``FaceReconModel.pb`` (``pipeline/rnet.py``).

Both checkpoint formats are LevelDB SSTables (48-byte footer with magic
``0xdb4775248b80fb57``, prefix-compressed blocks with restart arrays,
masked crc32c trailers); the V2 ``.index`` maps names to
``BundleEntryProto`` records that point into raw little-endian ``.data``
shards; protobuf wire format is decoded by hand.  ``write_bundle`` is the
matching V2 writer and ``write_graphdef_consts`` a writer of frozen-graph
weights.  The readers are held against TensorFlow's own
readback of the committed fixtures in ``tests/fixtures/tf_binary/``
(``tests/test_torch_weights_tf.py``).

Two departures from the reference copy: crc32c runs as many parallel
streams in numpy and combines them over GF(2) (the byte-serial loop took
minutes over a full-width PixRefer bundle), and bfloat16 tensors are
returned widened to float32 (exactly), so no ``ml_dtypes`` is needed.

Unsupported, failing loudly: snappy-compressed table blocks (TF writes
both checkpoint formats uncompressed), DT_STRING tensors, partitioned V2
slices.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), masked per LevelDB/TF convention
# ---------------------------------------------------------------------------

_CRC_TABLE: Optional[List[int]] = None


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # reflected Castagnoli
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


_SERIAL_BYTES = 4096     # below this, the byte loop
_STREAMS = 1 << 16       # parallel streams of the numpy form


def _crc_serial(data, reg: int) -> int:
    """The CRC register after ``data``, from register ``reg`` (no pre- or
    post-inversion)."""
    table = _crc_table()
    for b in data:
        reg = table[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _gf2_apply(cols: List[int], v: int) -> int:
    """A 32x32 GF(2) matrix (its 32 column images) times ``v``."""
    out = 0
    i = 0
    while v:
        if v & 1:
            out ^= cols[i]
        v >>= 1
        i += 1
    return out


def _zeros_operator(n: int) -> List[int]:
    """Column images of the register map of ``n`` zero bytes: the register
    update is linear over GF(2), so ``reg(a || b) = Z(len b) reg(a) ^
    reg_0(b)`` with ``reg_0`` the register from 0.  Z(1) is read off the
    table, Z(n) by repeated squaring."""
    one = [_crc_serial(b"\x00", 1 << i) for i in range(32)]
    result = [1 << i for i in range(32)]
    power = one
    while n:
        if n & 1:
            result = [_gf2_apply(power, c) for c in result]
        power = [_gf2_apply(power, c) for c in power]
        n >>= 1
    return result


def crc32c(data: bytes, crc: int = 0) -> int:
    """crc32c of ``data`` continuing ``crc``.  Long inputs run as
    ``_STREAMS`` byte-serial streams at once in numpy; leading zero bytes
    leave a register from 0 unchanged, so the data is front-padded to a
    multiple of the stream count, and neighbouring stream registers are
    folded pairwise with the zero-byte operator of the left one's span."""
    n = len(data)
    reg = crc ^ 0xFFFFFFFF
    if n < _SERIAL_BYTES:
        return _crc_serial(data, reg) ^ 0xFFFFFFFF
    buf = np.frombuffer(data, np.uint8)
    k = min(_STREAMS, n // 64)
    length = -(-n // k)
    padded = np.zeros(k * length, np.uint8)
    padded[k * length - n:] = buf
    lanes = np.ascontiguousarray(padded.reshape(k, length).T)
    table = np.asarray(_crc_table(), np.uint32)
    regs = np.zeros(k, np.uint32)
    for column in lanes:
        regs = table[(regs ^ column) & 0xFF] ^ (regs >> 8)
    while regs.size > 1:            # fold neighbouring streams pairwise
        if regs.size % 2:
            regs = np.concatenate([np.zeros(1, np.uint32), regs])
        step = np.asarray(_zeros_operator(length), np.uint32)
        left, right = regs[0::2], regs[1::2]
        folded = right.copy()
        for i in range(32):
            folded ^= np.where((left >> i) & 1 == 1, step[i], 0).astype(
                np.uint32)
        regs, length = folded, 2 * length
    return (_gf2_apply(_zeros_operator(n), reg) ^ int(regs[0])) ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15) | (c << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _unmask_crc(masked: int) -> int:
    rot = (masked - 0xA282EAD8) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire-format primitives
# ---------------------------------------------------------------------------


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 70:
            raise ValueError("corrupt varint")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) over a serialized message.

    Length-delimited payloads are the raw bytes; varint payloads are the
    varint-encoded bytes re-sliced (decode with ``_varint(payload, 0)``);
    fixed32/fixed64 payloads are 4/8 raw bytes.
    """
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                       # varint
            start = i
            _, i = _varint(buf, i)
            yield field, wire, buf[start:i]
        elif wire == 1:                     # fixed64
            yield field, wire, buf[i:i + 8]
            i += 8
        elif wire == 2:                     # length-delimited
            ln, i = _varint(buf, i)
            yield field, wire, buf[i:i + ln]
            i += ln
        elif wire == 5:                     # fixed32
            yield field, wire, buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _as_varint(payload: bytes) -> int:
    return _varint(payload, 0)[0]


def _encode_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode_field(field: int, wire: int, payload: bytes) -> bytes:
    return _encode_varint(field << 3 | wire) + payload


def _encode_bytes_field(field: int, data: bytes) -> bytes:
    return _encode_field(field, 2, _encode_varint(len(data)) + data)


# ---------------------------------------------------------------------------
# LevelDB SSTable container
# ---------------------------------------------------------------------------

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_LEN = 48  # 2 * max BlockHandle (2 * 10) + padding + 8-byte magic


def _read_block_handle(buf: bytes, i: int) -> Tuple[int, int, int]:
    offset, i = _varint(buf, i)
    size, i = _varint(buf, i)
    return offset, size, i


def _read_block(data: bytes, offset: int, size: int,
                verify_crc: bool) -> bytes:
    """Return decompressed block contents (trailer checked/stripped)."""
    block = data[offset:offset + size]
    trailer = data[offset + size:offset + size + 5]
    if len(block) != size or len(trailer) != 5:
        raise ValueError("table block extends past end of file")
    if verify_crc:
        expect = _unmask_crc(struct.unpack("<I", trailer[1:])[0])
        if crc32c(trailer[:1], crc32c(block)) != expect:
            raise ValueError(f"table block at {offset} fails crc32c")
    if trailer[0] == 0:
        return block
    if trailer[0] == 1:
        raise NotImplementedError(
            "snappy-compressed table block: TF writes checkpoints "
            "uncompressed; this file was produced by something else")
    raise ValueError(f"unknown block type {trailer[0]}")


def _iter_block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key, value) pairs from one table block."""
    if len(block) < 4:
        raise ValueError("truncated table block")
    num_restarts = struct.unpack("<I", block[-4:])[0]
    end = len(block) - 4 * (num_restarts + 1)
    if end < 0:
        raise ValueError("corrupt restart array")
    i = 0
    key = b""
    while i < end:
        shared, i = _varint(block, i)
        unshared, i = _varint(block, i)
        value_len, i = _varint(block, i)
        key = key[:shared] + block[i:i + unshared]
        i += unshared
        yield key, block[i:i + value_len]
        i += value_len


def iter_table(data: bytes, verify_crc: bool = True) \
        -> Iterator[Tuple[bytes, bytes]]:
    """Yield all (key, value) entries of an SSTable file, in key order."""
    if len(data) < _FOOTER_LEN:
        raise ValueError("file too small to be an SSTable")
    footer = data[-_FOOTER_LEN:]
    magic, = struct.unpack("<Q", footer[40:48])
    if magic != _TABLE_MAGIC:
        raise ValueError(
            f"bad SSTable magic {magic:#x} (not a TF checkpoint file?)")
    i = 0
    _meta_off, _meta_sz, i = _read_block_handle(footer, i)
    index_off, index_sz, i = _read_block_handle(footer, i)
    index = _read_block(data, index_off, index_sz, verify_crc)
    for _sep_key, handle in _iter_block_entries(index):
        off, sz, _ = _read_block_handle(handle, 0)
        for key, value in _iter_block_entries(
                _read_block(data, off, sz, verify_crc)):
            yield key, value


# ---------------------------------------------------------------------------
# dtypes and TensorProto / TensorShapeProto decoding
# ---------------------------------------------------------------------------

# tensorflow/core/framework/types.proto enum -> numpy dtype
_DTYPES: Dict[int, np.dtype] = {
    1: np.dtype(np.float32), 2: np.dtype(np.float64),
    3: np.dtype(np.int32), 4: np.dtype(np.uint8), 5: np.dtype(np.int16),
    6: np.dtype(np.int8), 9: np.dtype(np.int64), 10: np.dtype(np.bool_),
    17: np.dtype(np.uint16), 19: np.dtype(np.float16),
    22: np.dtype(np.uint32), 23: np.dtype(np.uint64),
}
_DTYPE_ENUM = {v: k for k, v in _DTYPES.items()}
_DT_STRING = 7
_DT_BFLOAT16 = 14

# TensorProto typed repeated value fields (tensor.proto): field -> dtype
_TYPED_VAL_FIELDS = {
    5: np.dtype(np.float32),   # float_val
    6: np.dtype(np.float64),   # double_val
    7: np.dtype(np.int32),     # int_val (int8/16/32, uint8/16 share it)
    10: np.dtype(np.int64),    # int64_val
    11: np.dtype(np.bool_),    # bool_val
    13: np.dtype(np.uint16),   # half_val (f16/bf16 bit patterns)
    16: np.dtype(np.uint32),   # uint32_val
    17: np.dtype(np.uint64),   # uint64_val
}
_FIXED_WIDTH_VAL = {5: "<f4", 6: "<f8", 16: None, 17: None}


def _parse_shape(payload: bytes) -> List[int]:
    """TensorShapeProto: repeated Dim dim = 2 {int64 size = 1}."""
    dims: List[int] = []
    for field, _wire, p in _fields(payload):
        if field == 2:
            size = 0
            for f2, _w2, p2 in _fields(p):
                if f2 == 1:
                    size = _as_varint(p2)
                    if size >= 1 << 63:       # negative int64 (unknown dim)
                        size -= 1 << 64
            dims.append(size)
        elif field == 3 and _as_varint(p):
            raise ValueError("unknown-rank tensor shape")
    return dims


def _decode_typed_values(field: int, wire: int, payload: bytes,
                         out: List[np.ndarray]) -> None:
    """Append the values of one typed TensorProto field occurrence."""
    if wire == 2:  # packed
        dt = _TYPED_VAL_FIELDS[field]
        if field in (5, 6):
            out.append(np.frombuffer(payload, _FIXED_WIDTH_VAL[field]))
        else:
            vals, i = [], 0
            while i < len(payload):
                v, i = _varint(payload, i)
                vals.append(v)
            out.append(np.array(vals, np.uint64).astype(dt, casting="unsafe"))
    elif wire == 0:
        v = _as_varint(payload)
        out.append(np.array([v], np.uint64).astype(
            _TYPED_VAL_FIELDS[field], casting="unsafe"))
    elif wire == 5 and field == 5:
        out.append(np.frombuffer(payload, "<f4"))
    elif wire == 1 and field == 6:
        out.append(np.frombuffer(payload, "<f8"))
    else:
        raise ValueError(f"unexpected wire {wire} for value field {field}")


def parse_tensor_proto(payload: bytes,
                       dtype_enum: Optional[int] = None,
                       shape: Optional[List[int]] = None) -> np.ndarray:
    """Decode a TensorProto to an ndarray.

    ``dtype_enum``/``shape`` override the proto's own fields when the
    container stores them externally (the V1 SavedSlice case, where
    the data TensorProto carries only the typed value field).
    """
    content: Optional[bytes] = None
    vals: List[np.ndarray] = []
    val_field: Optional[int] = None
    for field, wire, p in _fields(payload):
        if field == 1:
            dtype_enum = _as_varint(p)
        elif field == 2:
            shape = _parse_shape(p)
        elif field == 4:
            content = p
        elif field in _TYPED_VAL_FIELDS:
            if val_field is not None and val_field != field:
                raise ValueError("TensorProto mixes typed value fields")
            val_field = field
            _decode_typed_values(field, wire, p, vals)
        elif field == 8:
            raise NotImplementedError("DT_STRING tensors are unsupported")
    if dtype_enum is None or shape is None:
        raise ValueError("TensorProto lacks dtype/shape")
    if dtype_enum == _DT_STRING:
        raise NotImplementedError("DT_STRING tensors are unsupported")
    if dtype_enum == _DT_BFLOAT16:
        np_dtype = np.dtype(np.uint16)      # bit patterns, widened below
    else:
        if dtype_enum not in _DTYPES:
            raise NotImplementedError(f"dtype enum {dtype_enum}")
        np_dtype = _DTYPES[dtype_enum]
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if content is not None:
        arr = np.frombuffer(content, np_dtype.newbyteorder("<"))
    elif vals:
        flat = np.concatenate(vals)
        if dtype_enum == 19:                 # bit patterns in half_val
            flat = flat.astype(np.uint16).view(np_dtype)
        arr = flat.astype(np_dtype, casting="unsafe")
    else:
        arr = np.zeros(0, np_dtype)
    if arr.size < size:
        # TF semantics (tensor_util.MakeNdarray): missing trailing values
        # repeat the last given one; an empty proto means all zeros.
        fill = arr[-1] if arr.size else np.zeros((), np_dtype)
        arr = np.concatenate(
            [arr, np.full(size - arr.size, fill, np_dtype)])
    if arr.size != size:
        raise ValueError(
            f"TensorProto has {arr.size} values for shape {shape}")
    arr = arr.reshape(shape).astype(np_dtype, copy=False)
    return _widen_bfloat16(arr) if dtype_enum == _DT_BFLOAT16 else arr


def _widen_bfloat16(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns -> the same values as float32 (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


# ---------------------------------------------------------------------------
# V2 TensorBundle reader
# ---------------------------------------------------------------------------


def _parse_bundle_entry(payload: bytes):
    """BundleEntryProto: dtype=1, shape=2, shard_id=3, offset=4, size=5,
    crc32c=6 (fixed32), slices=7."""
    dtype_enum, shape, shard, offset, size, crc = 1, [], 0, 0, 0, None
    for field, _wire, p in _fields(payload):
        if field == 1:
            dtype_enum = _as_varint(p)
        elif field == 2:
            shape = _parse_shape(p)
        elif field == 3:
            shard = _as_varint(p)
        elif field == 4:
            offset = _as_varint(p)
        elif field == 5:
            size = _as_varint(p)
        elif field == 6:
            crc = struct.unpack("<I", p)[0]
        elif field == 7:
            raise NotImplementedError(
                "partitioned-variable bundle slices are unsupported")
    return dtype_enum, shape, shard, offset, size, crc


def _bundle_shard_path(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def read_bundle(prefix: str, verify_crc: bool = False,
                names: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    """Read a V2 TensorBundle checkpoint (``tf.train.Saver`` output) into
    ``{variable_name: ndarray}`` with no TensorFlow dependency.

    ``prefix`` is the checkpoint prefix (e.g. ``ckpt_bfmnet/bfmnet-65000``);
    ``<prefix>.index`` and the ``.data-*`` shards it references must exist.
    ``verify_crc`` additionally checks each tensor's stored crc32c
    (pure-Python; slow on very large checkpoints).  ``names`` restricts
    decoding to the given variables.
    """
    index_path = prefix + ".index"
    with open(index_path, "rb") as f:
        index_data = f.read()
    num_shards = 1
    entries: List[Tuple[str, tuple]] = []
    for key, value in iter_table(index_data, verify_crc=True):
        if key == b"":
            for field, _wire, p in _fields(value):  # BundleHeaderProto
                if field == 1:
                    num_shards = _as_varint(p)
            continue
        name = key.decode("utf-8")
        if names is not None and name not in names:
            continue
        entries.append((name, _parse_bundle_entry(value)))
    shards: Dict[int, np.memmap] = {}
    out: Dict[str, np.ndarray] = {}
    for name, (dtype_enum, shape, shard, offset, size, crc) in entries:
        if shard not in shards:
            shards[shard] = np.memmap(
                _bundle_shard_path(prefix, shard, num_shards), np.uint8, "r")
        raw = bytes(shards[shard][offset:offset + size])
        if len(raw) != size:
            raise ValueError(f"{name}: data shard truncated")
        if verify_crc and crc is not None \
                and masked_crc32c(raw) != crc:
            raise ValueError(f"{name}: tensor data fails crc32c")
        if dtype_enum == _DT_STRING:
            raise NotImplementedError(f"{name}: DT_STRING unsupported")
        if dtype_enum == _DT_BFLOAT16:
            np_dtype = np.dtype(np.uint16)
        elif dtype_enum in _DTYPES:
            np_dtype = _DTYPES[dtype_enum]
        else:
            raise NotImplementedError(f"{name}: dtype enum {dtype_enum}")
        arr = np.frombuffer(raw, np_dtype.newbyteorder("<"))
        expect = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if arr.size != expect:
            raise ValueError(
                f"{name}: {arr.size} elements for shape {shape}")
        arr = arr.reshape(shape).astype(np_dtype, copy=False)
        out[name] = (_widen_bfloat16(arr) if dtype_enum == _DT_BFLOAT16
                     else arr)
    return out


# ---------------------------------------------------------------------------
# V2 TensorBundle writer (pure NumPy)
# ---------------------------------------------------------------------------


def _build_block(entries: List[Tuple[bytes, bytes]]) -> bytes:
    """Serialize one table block with every entry a restart point (valid
    LevelDB format; zero prefix compression keeps the writer simple and
    TF's reader seeks correctly)."""
    out = bytearray()
    restarts: List[int] = []
    for key, value in entries:
        restarts.append(len(out))
        out += _encode_varint(0)             # shared
        out += _encode_varint(len(key))      # unshared
        out += _encode_varint(len(value))
        out += key + value
    if not restarts:
        restarts = [0]
    for r in restarts:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts))
    return bytes(out)


def _append_block(sink: bytearray, block: bytes) -> bytes:
    """Append block + trailer to sink; return the encoded BlockHandle."""
    offset = len(sink)
    sink += block
    trailer_type = b"\x00"
    crc = crc32c(trailer_type, crc32c(block))
    masked = ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF
    sink += trailer_type + struct.pack("<I", masked)
    return _encode_varint(offset) + _encode_varint(len(block))


def _encode_shape(shape: Tuple[int, ...]) -> bytes:
    out = b""
    for d in shape:
        out += _encode_bytes_field(2, _encode_field(1, 0, _encode_varint(d)))
    return out


def write_bundle(arrays: Dict[str, np.ndarray], prefix: str) -> None:
    """Write ``{name: ndarray}`` as a V2 TensorBundle: sorted keys, every
    entry a restart point, masked crc32c trailers and per-tensor
    checksums, byte for byte what the reference copy writes (whose output
    TensorFlow's ``tf.train.load_checkpoint`` reads back exactly)."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    names = sorted(arrays)
    data = bytearray()
    index_entries: List[Tuple[bytes, bytes]] = []
    header = _encode_field(1, 0, _encode_varint(1)) \
        + _encode_bytes_field(3, _encode_field(1, 0, _encode_varint(1)))
    index_entries.append((b"", header))
    for name in names:
        # NOT ascontiguousarray: it promotes 0-d arrays to 1-d, which would
        # change a scalar's saved shape; tobytes() copies C-order anyway.
        arr = np.asarray(arrays[name])
        if arr.dtype not in _DTYPE_ENUM:
            raise NotImplementedError(f"{name}: dtype {arr.dtype}")
        raw = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        entry = _encode_field(1, 0, _encode_varint(_DTYPE_ENUM[arr.dtype]))
        entry += _encode_bytes_field(2, _encode_shape(arr.shape))
        entry += _encode_field(4, 0, _encode_varint(len(data)))
        entry += _encode_field(5, 0, _encode_varint(len(raw)))
        entry += _encode_field(6, 5, struct.pack("<I", masked_crc32c(raw)))
        index_entries.append((name.encode("utf-8"), entry))
        data += raw
    with open(_bundle_shard_path(prefix, 0, 1), "wb") as f:
        f.write(bytes(data))

    # .index: data blocks of ~4 KB, then metaindex, index block, footer
    sink = bytearray()
    data_handles: List[Tuple[bytes, bytes]] = []  # (last_key, handle)
    block: List[Tuple[bytes, bytes]] = []
    block_bytes = 0
    for key, value in index_entries:
        block.append((key, value))
        block_bytes += len(key) + len(value) + 12
        if block_bytes >= 4096:
            data_handles.append(
                (key, _append_block(sink, _build_block(block))))
            block, block_bytes = [], 0
    if block:
        data_handles.append(
            (block[-1][0], _append_block(sink, _build_block(block))))
    meta_handle = _append_block(sink, _build_block([]))
    index_handle = _append_block(
        sink, _build_block([(k, h) for k, h in data_handles]))
    footer = meta_handle + index_handle
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", _TABLE_MAGIC)
    sink += footer
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(sink))


# ---------------------------------------------------------------------------
# V1 checkpoint reader (single-file, e.g. the slim vgg_16.ckpt)
# ---------------------------------------------------------------------------


def _parse_slice_proto(payload: bytes) -> List[Tuple[int, int]]:
    """TensorSliceProto: repeated Extent extent = 1 {start=1, length=2}.
    A dimension with no length is a full-dimension extent (length -1)."""
    extents: List[Tuple[int, int]] = []
    for field, _wire, p in _fields(payload):
        if field == 1:
            start, length = 0, -1
            for f2, _w2, p2 in _fields(p):
                if f2 == 1:
                    start = _as_varint(p2)
                elif f2 == 2:
                    length = _as_varint(p2)
            extents.append((start, length))
    return extents


def read_v1_checkpoint(path: str,
                       verify_crc: bool = True) -> Dict[str, np.ndarray]:
    """Read a V1 (pre-bundle) single-file TF checkpoint — the format of the
    2016 slim releases like ``vgg_16.ckpt`` — into ``{name: ndarray}``.

    The file is one SSTable: key ``""`` holds ``SavedTensorSliceMeta``
    (names, dtypes, shapes); every other entry's value is a
    ``SavedTensorSlices`` whose ``data`` SavedSlice carries the tensor name,
    the slice extent, and a typed-field TensorProto.  Multi-slice tensors
    are reassembled via their extents.
    """
    with open(path, "rb") as f:
        data = f.read()
    meta: Dict[str, Tuple[int, List[int]]] = {}
    pieces: Dict[str, List[Tuple[List[Tuple[int, int]], bytes]]] = {}
    for key, value in iter_table(data, verify_crc=verify_crc):
        # SavedTensorSlices: meta=1, data=2
        for field, _wire, p in _fields(value):
            if field == 1 and key == b"":
                # SavedTensorSliceMeta: repeated SavedSliceMeta tensor = 1
                for f2, _w2, tensor in _fields(p):
                    if f2 != 1:
                        continue
                    name, dtype_enum, shape = None, None, []
                    for f3, _w3, p3 in _fields(tensor):
                        if f3 == 1:
                            name = p3.decode("utf-8")
                        elif f3 == 2:
                            shape = _parse_shape(p3)
                        elif f3 == 3:
                            dtype_enum = _as_varint(p3)
                    if name is not None:
                        meta[name] = (dtype_enum, shape)
            elif field == 2:
                # SavedSlice: name=1, slice=2, data=3 (TensorProto)
                name, extents, tensor_payload = None, [], None
                for f2, _w2, p2 in _fields(p):
                    if f2 == 1:
                        name = p2.decode("utf-8")
                    elif f2 == 2:
                        extents = _parse_slice_proto(p2)
                    elif f2 == 3:
                        tensor_payload = p2
                if name is None or tensor_payload is None:
                    raise ValueError("SavedSlice without name/data")
                pieces.setdefault(name, []).append((extents, tensor_payload))
    out: Dict[str, np.ndarray] = {}
    for name, slices in pieces.items():
        if name not in meta:
            raise ValueError(f"slice for unknown tensor {name!r}")
        dtype_enum, shape = meta[name]
        full = None
        for extents, payload in slices:
            starts = [s for s, _ in extents]
            lengths = [ln if ln >= 0 else dim - st for (st, ln), dim
                       in zip(extents, shape)]
            arr = parse_tensor_proto(payload, dtype_enum=dtype_enum,
                                     shape=lengths)
            if starts == [0] * len(shape) and lengths == shape:
                full = arr
                break
            if full is None:
                full = np.zeros(shape, arr.dtype)
            full[tuple(slice(s, s + ln)
                       for s, ln in zip(starts, lengths))] = arr
        out[name] = full
    return out


def read_checkpoint(path: str,
                    verify_crc: bool = False) -> Dict[str, np.ndarray]:
    """Read either checkpoint format by path/prefix.

    Accepts a V2 prefix (``.../bfmnet-65000``, with ``.index`` next to it)
    or a V1 single file (``.../vgg_16.ckpt``).  Mirrors what
    ``tf.train.load_checkpoint`` accepts for the reference's assets.
    """
    if os.path.exists(path + ".index"):
        return read_bundle(path, verify_crc=verify_crc)
    if os.path.exists(path):
        return read_v1_checkpoint(path, verify_crc=verify_crc or True)
    raise FileNotFoundError(
        f"no checkpoint at {path!r} (neither {path}.index nor the file)")


# ---------------------------------------------------------------------------
# Frozen GraphDef Const extraction
# ---------------------------------------------------------------------------


def read_graphdef_consts(path: str,
                         name_filter: Optional[str] = None
                         ) -> Dict[str, np.ndarray]:
    """Extract every ``Const`` node's tensor from a frozen GraphDef
    (``FaceReconModel.pb``-shaped files) into
    ``{node_name: ndarray}``.

    ``name_filter`` is an optional regex; only matching node names decode
    (e.g. ``"resnet_v1_50"`` for the R-Net weights).  DT_STRING consts are
    skipped (they carry no weights).
    """
    with open(path, "rb") as f:
        data = f.read()
    pattern = re.compile(name_filter) if name_filter else None
    out: Dict[str, np.ndarray] = {}
    for field, _wire, node in _fields(data):   # GraphDef: node = 1
        if field != 1:
            continue
        name, op, tensor_payload = None, None, None
        for f2, _w2, p2 in _fields(node):      # NodeDef
            if f2 == 1:
                name = p2.decode("utf-8")
            elif f2 == 2:
                op = p2.decode("utf-8")
            elif f2 == 5:                      # map<string, AttrValue>
                attr_key, attr_value = None, None
                for f3, _w3, p3 in _fields(p2):
                    if f3 == 1:
                        attr_key = p3.decode("utf-8")
                    elif f3 == 2:
                        attr_value = p3
                if attr_key == "value" and attr_value is not None:
                    for f4, _w4, p4 in _fields(attr_value):  # AttrValue
                        if f4 == 8:            # tensor
                            tensor_payload = p4
        if op != "Const" or name is None or tensor_payload is None:
            continue
        if pattern is not None and not pattern.search(name):
            continue
        try:
            out[name] = parse_tensor_proto(tensor_payload)
        except NotImplementedError:
            continue   # DT_STRING / exotic consts carry no weights
    return out


def write_graphdef_consts(arrays: Dict[str, np.ndarray], path: str) -> None:
    """Write ``{name: ndarray}`` as a GraphDef of ``Const`` nodes (a frozen
    graph's weights, the form :func:`read_graphdef_consts` reads): per
    node the name, the op and a ``value`` attr holding a TensorProto with
    dtype, shape and ``tensor_content``."""
    with open(path, "wb") as f:
        for name, arr in arrays.items():
            arr = np.asarray(arr)
            if arr.dtype not in _DTYPE_ENUM:
                raise NotImplementedError(f"{name}: dtype {arr.dtype}")
            tensor = _encode_field(1, 0, _encode_varint(_DTYPE_ENUM[arr.dtype]))
            tensor += _encode_bytes_field(2, _encode_shape(arr.shape))
            tensor += _encode_bytes_field(4, arr.astype(
                arr.dtype.newbyteorder("<"), copy=False).tobytes())
            attr = _encode_bytes_field(1, b"value") + _encode_bytes_field(
                2, _encode_bytes_field(8, tensor))
            node = (_encode_bytes_field(1, name.encode("utf-8"))
                    + _encode_bytes_field(2, b"Const")
                    + _encode_bytes_field(5, attr))
            f.write(_encode_bytes_field(1, node))


# ---------------------------------------------------------------------------
# the released slim VGG-16 (vgg_16.ckpt) for the perceptual loss
# ---------------------------------------------------------------------------

# the reference restores conv1-conv4 (train_pixrefer.py:80-92); its exclude
# list (vgg_simple.py:160) drops fc6/7/8, conv5 and the pools
VGG16_EXCLUDE_PREFIXES = (
    "vgg_16/fc6", "vgg_16/pool4", "vgg_16/conv5", "vgg_16/pool5",
    "vgg_16/fc7", "vgg_16/global_pool", "vgg_16/fc8/squeezed", "vgg_16/fc8",
    # bookkeeping variables of slim checkpoints
    "global_step", "vgg_16/mean_rgb",
)


def vgg16_slim_name_map() -> List[Tuple[str, str]]:
    """(slim checkpoint name, state_dict key) rows:
    ``vgg_16/conv{i}/conv{i}_{j}/{weights,biases}`` ->
    ``conv{i}_{j}.{weight,bias}`` of ``models.vgg.VGG16Features``."""
    from voicepuppet_torch.models.vgg import STACKS
    rows: List[Tuple[str, str]] = []
    for reps, stack in STACKS:
        for j in range(1, reps + 1):
            slim = f"vgg_16/{stack}/{stack}_{j}"
            rows.append((f"{slim}/weights", f"{stack}_{j}.weight"))
            rows.append((f"{slim}/biases", f"{stack}_{j}.bias"))
    return rows


def load_vgg16_checkpoint(path: str, target):
    """``vgg_16.ckpt`` (V1 or V2), read with no TensorFlow ->
    ``(state, loaded, missing)`` for ``target`` (a ``VGG16Features`` or
    its state_dict).  Slim kernels are HWIO and go to torch's OIHW.  Any
    variable that is neither mapped nor on the reference's exclude list
    raises, so a renamed release fails loudly; a mis-shaped trunk variable
    lands in ``missing``."""
    import torch
    arrays = read_checkpoint(path)
    mapped = dict(vgg16_slim_name_map())
    for name in arrays:
        if name not in mapped and not any(
                name.startswith(p) for p in VGG16_EXCLUDE_PREFIXES):
            raise ValueError(f"unexpected variable {name!r} in vgg_16 "
                             "checkpoint (not in the conv1-4 map or the "
                             "exclude list)")
    own = target.state_dict() if hasattr(target, "state_dict") else target
    state, loaded, missing = {}, [], []
    for tf_name, key in mapped.items():
        val = arrays.get(tf_name)
        if val is not None and val.ndim == 4:
            val = np.transpose(val, (3, 2, 0, 1))
        if val is None or key not in own or tuple(own[key].shape) \
                != val.shape:
            missing.append(tf_name)
            continue
        state[key] = torch.from_numpy(np.ascontiguousarray(val, np.float32))
        loaded.append(tf_name)
    return state, loaded, missing
