"""Grayscale TIFF read/write for CTC datasets.

Reference parity: arbellea/LSTM-UNet decodes ``t*.tif`` via cv2/imageio and
writes uint16 instance masks ``mask###.tif`` (SURVEY.md §2 "Inference reader",
"Inference driver"; BASELINE.json "TIFF in/out").

The main path needs nothing beyond numpy: a small codec here reads and
writes baseline TIFF with uncompressed uint8/uint16 strips, which covers
everything :func:`write_tiff` and the synthetic writer produce. Compressed
inputs (real CTC data may use LZW or deflate) go to the native C codec
(``native/tiffio``, built by ``make -C native``), then cv2, then PIL,
whichever is present; with none of them such a file raises.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

_cv2 = None
_pil = None
_native = None

# TIFF tag ids and field types used by the numpy codec
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP, _STRIP_COUNTS = 273, 277, 278, 279
_PLANAR, _SAMPLE_FORMAT = 284, 339
_TYPE_CODES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q"}


def _read_uncompressed(path: str) -> Optional[np.ndarray]:
    """Decode a TIFF whose first image is uncompressed uint8/uint16 strips.

    Returns None for anything else (compression, tiles, floats) so the
    caller can try a fuller decoder; raises on a file that is not a TIFF.
    """
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] == b"II*\x00":
        bo = "<"
    elif buf[:4] == b"MM\x00*":
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF file")
    (ifd,) = struct.unpack_from(bo + "I", buf, 4)
    (n,) = struct.unpack_from(bo + "H", buf, ifd)
    tags = {}
    for i in range(n):
        tag, typ, count, raw = struct.unpack_from(
            bo + "HHI4s", buf, ifd + 2 + 12 * i)
        code = _TYPE_CODES.get(typ)
        if code is None:
            continue
        size = struct.calcsize(code) * count
        data = raw if size <= 4 else buf[
            struct.unpack(bo + "I", raw)[0]:][:size]
        tags[tag] = struct.unpack_from(bo + code * count, data)
    width, height = tags[_WIDTH][0], tags[_LENGTH][0]
    bits = tags.get(_BITS, (1,))
    spp = tags.get(_SAMPLES, (1,))[0]
    if (tags.get(_COMPRESSION, (1,))[0] != 1
            or _STRIP_OFFSETS not in tags
            or len(set(bits)) != 1 or bits[0] not in (8, 16)
            or tags.get(_SAMPLE_FORMAT, (1,))[0] != 1
            or (spp > 1 and tags.get(_PLANAR, (1,))[0] != 1)):
        return None
    dtype = np.dtype(np.uint8 if bits[0] == 8 else np.uint16).newbyteorder(bo)
    row_bytes = width * spp * dtype.itemsize
    counts = tags.get(_STRIP_COUNTS)
    rows_per_strip = tags.get(_ROWS_PER_STRIP, (height,))[0]
    chunks = []
    for k, off in enumerate(tags[_STRIP_OFFSETS]):
        rows = min(rows_per_strip, height - k * rows_per_strip)
        nbytes = counts[k] if counts else rows * row_bytes
        chunks.append(buf[off: off + min(nbytes, rows * row_bytes)])
    raw = b"".join(chunks)
    if len(raw) != height * row_bytes:
        raise ValueError(f"{path}: truncated strip data")
    arr = np.frombuffer(raw, dtype).reshape(height, width, spp)[..., 0]
    return arr.astype(dtype.newbyteorder("="))


def _write_uncompressed(path: str, arr: np.ndarray) -> None:
    """Little-endian baseline TIFF, one uncompressed strip."""
    h, w = arr.shape
    data = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<")).tobytes()
    entries = [  # (tag, type, value), sorted by tag as TIFF requires
        (_WIDTH, 4, w), (_LENGTH, 4, h), (_BITS, 3, arr.dtype.itemsize * 8),
        (_COMPRESSION, 3, 1), (_PHOTOMETRIC, 3, 1), (_STRIP_OFFSETS, 4, 0),
        (_SAMPLES, 3, 1), (_ROWS_PER_STRIP, 4, h),
        (_STRIP_COUNTS, 4, len(data)), (_SAMPLE_FORMAT, 3, 1)]
    ifd_size = 2 + 12 * len(entries) + 4
    data_off = 8 + ifd_size
    ifd = struct.pack("<H", len(entries))
    for tag, typ, val in entries:
        if tag == _STRIP_OFFSETS:
            val = data_off
        # a one-value field is left-justified in the entry's 4 bytes
        packed = (struct.pack("<HH", val, 0) if typ == 3
                  else struct.pack("<I", val))
        ifd += struct.pack("<HHI", tag, typ, 1) + packed
    ifd += struct.pack("<I", 0)  # no next IFD
    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", 8) + ifd + data)


def _get_native():
    global _native
    if _native is None:
        from ..io import _tiffio_native as m  # ctypes wrapper, native/tiffio

        _native = m if m.available() else False
    return _native


def _get_cv2():
    global _cv2
    if _cv2 is None:
        try:
            import cv2
        except ImportError:
            cv2 = False
        _cv2 = cv2
    return _cv2


def _get_pil():
    global _pil
    if _pil is None:
        try:
            from PIL import Image
        except ImportError:
            Image = False
        _pil = Image
    return _pil


def read_tiff(path: str) -> np.ndarray:
    """Read a grayscale TIFF as a 2D numpy array (uint8/uint16/float preserved)."""
    arr = _read_uncompressed(path)
    if arr is not None:
        return arr
    nat = _get_native()
    if nat:
        arr = nat.read(path)
        if arr is not None:
            return arr
    cv2 = _get_cv2()
    if cv2:
        arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if arr is not None:
            return arr[..., 0] if arr.ndim == 3 else arr  # gray stored as RGB
    pil = _get_pil()
    if pil:
        with pil.open(path) as im:
            arr = np.asarray(im)
            return arr[..., 0] if arr.ndim == 3 else arr
    raise RuntimeError(
        f"{path}: compressed or non-integer TIFF and no decoder for it "
        "(build native/ with `make -C native`, or install cv2 or Pillow)")


def write_tiff(path: str, arr: np.ndarray) -> None:
    """Write a 2D uint8/uint16 array as TIFF (CTC masks are uint16 [H])."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"CTC TIFF output must be uint8/uint16, got {arr.dtype}")
    if arr.ndim != 2:
        raise ValueError(f"TIFF output must be 2-D, got shape {arr.shape}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _write_uncompressed(path, arr)
