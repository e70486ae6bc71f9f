"""TensorBoard event files without TensorFlow (port of
``voicepuppet_tpu/utils/tb_writer.py``).

Writes and reads the scalar, image and histogram summaries the reference
logs through tf.summary (train_pixrefer.py:101-131, gradient histograms
train_pixflow.py:113-115): TFRecord framing (length + masked crc32c) and
the few Event/Summary protobuf fields these need, hand-encoded.  The
crc32c and the protobuf primitives are those of ``tools/tf_bundle.py``.

  * record: uint64 len | uint32 masked_crc(len) | data | masked_crc(data)
  * Event: 1=wall_time double, 2=step int64, 3=file_version string,
    5=summary message
  * Summary.Value: 1=tag, 2=simple_value float, 4=image, 5=histo
  * Summary.Image: 1=height, 2=width, 3=colorspace, 4=encoded PNG
  * HistogramProto: 1=min, 2=max, 3=num, 4=sum, 5=sum_squares (doubles),
    6=bucket_limit, 7=bucket (packed repeated double)
"""

from __future__ import annotations

import io
import os
import socket
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from voicepuppet_torch.tools.tf_bundle import (_as_varint,
                                               _encode_bytes_field,
                                               _encode_field,
                                               _encode_varint, _fields,
                                               masked_crc32c)


def _double(field: int, value: float) -> bytes:
    return _encode_field(field, 1, struct.pack("<d", value))


def _varint_field(field: int, value: int) -> bytes:
    return _encode_field(field, 0, _encode_varint(value & (2 ** 64 - 1)))


def _str(field: int, value: str) -> bytes:
    return _encode_bytes_field(field, value.encode("utf-8"))


def _packed_doubles(field: int, values) -> bytes:
    values = [float(v) for v in values]
    return _encode_bytes_field(field, struct.pack(f"<{len(values)}d",
                                                  *values))


def _event(step: Optional[int] = None, summary: Optional[bytes] = None,
           file_version: Optional[str] = None) -> bytes:
    out = _double(1, time.time())
    if step is not None:
        out += _varint_field(2, step)
    if file_version is not None:
        out += _str(3, file_version)
    if summary is not None:
        out += _encode_bytes_field(5, summary)
    return out


def _to_uint8(image: np.ndarray) -> np.ndarray:
    """uint8 as is; floats in [0, 1] (or 0..255 when their max is above
    1.5) clipped to uint8."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.5 else arr, 0,
                      255).astype(np.uint8)
    return arr


class TBEventWriter:
    """Append-only event file: ``scalar`` / ``image`` / ``histogram`` +
    ``flush`` / ``close``."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname() or "host"
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}.{host}"
            f"{filename_suffix}")
        self._f = open(self.path, "ab")
        self._write_record(_event(file_version="brain.Event:2"))

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header + struct.pack("<I", masked_crc32c(header))
                      + data + struct.pack("<I", masked_crc32c(data)))

    def _value(self, step: int, value: bytes):
        self._write_record(_event(step=step,
                                  summary=_encode_bytes_field(1, value)))

    def scalar(self, tag: str, value: float, step: int):
        self._value(step, _str(1, tag) + _encode_field(
            2, 5, struct.pack("<f", float(value))))

    def image(self, tag: str, image: np.ndarray, step: int):
        """image: [H, W, 3] uint8 or [0,1]/[0,255] float, stored as PNG."""
        from PIL import Image
        arr = _to_uint8(image)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        msg = (_varint_field(1, arr.shape[0]) + _varint_field(2, arr.shape[1])
               + _varint_field(3, 3) + _encode_bytes_field(4, buf.getvalue()))
        self._value(step, _str(1, tag) + _encode_bytes_field(4, msg))

    def histogram(self, tag: str, values: np.ndarray, step: int,
                  bins: int = 30):
        """Histogram of the finite entries of ``values`` (a NaN would
        poison the bucket edges)."""
        arr = np.asarray(values, np.float64).ravel()
        arr = arr[np.isfinite(arr)]
        if arr.size == 0:
            arr = np.zeros((1,), np.float64)
        mn, mx = float(arr.min()), float(arr.max())
        if mx > mn:
            counts, edges = np.histogram(arr, bins=bins)
            limits = edges[1:]
        else:
            counts, limits = np.asarray([arr.size]), np.asarray([mx])
        histo = (_double(1, mn) + _double(2, mx) + _double(3, float(arr.size))
                 + _double(4, float(arr.sum()))
                 + _double(5, float(np.square(arr).sum()))
                 + _packed_doubles(6, limits) + _packed_doubles(7, counts))
        self._value(step, _str(1, tag) + _encode_bytes_field(5, histo))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def _parse_histo(data: bytes) -> Dict[str, object]:
    names = {1: "min", 2: "max", 3: "num", 4: "sum", 5: "sum_squares"}
    out: Dict[str, object] = {"bucket_limit": [], "bucket": []}
    for field, wire, val in _fields(data):
        if field in names and wire == 1:
            (out[names[field]],) = struct.unpack("<d", val)
        elif field in (6, 7) and wire == 2:
            out["bucket_limit" if field == 6 else "bucket"] = list(
                struct.unpack(f"<{len(val) // 8}d", val))
    return out


def _parse_event(payload: bytes) -> Tuple[int, Dict[str, object]]:
    step, values = 0, {}
    for field, wire, val in _fields(payload):
        if field == 2 and wire == 0:
            step = _as_varint(val)
        elif field == 5 and wire == 2:
            for f2, w2, v2 in _fields(val):
                if f2 != 1 or w2 != 2:
                    continue
                tag, got = None, None
                for f3, w3, v3 in _fields(v2):
                    if f3 == 1:
                        tag = v3.decode("utf-8")
                    elif f3 == 2 and w3 == 5:
                        (got,) = struct.unpack("<f", v3)
                    elif f3 == 4 and w3 == 2:
                        got = next((v4 for f4, _w, v4 in _fields(v3)
                                    if f4 == 4), None)
                    elif f3 == 5 and w3 == 2:
                        got = _parse_histo(v3)
                if tag is not None:
                    values[tag] = got
    return step, values


def read_events(path: str) -> List[Tuple[int, Dict[str, object]]]:
    """(step, {tag: float, PNG bytes or histogram dict}) per record,
    checking both crcs of every record."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        if hcrc != masked_crc32c(header):
            raise ValueError(f"{path}: header crc mismatch at {pos}")
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if pcrc != masked_crc32c(payload):
            raise ValueError(f"{path}: payload crc mismatch at {pos}")
        pos += 16 + length
        out.append(_parse_event(payload))
    return out
