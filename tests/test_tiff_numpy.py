"""The numpy TIFF codec carries the main path with cv2 and PIL absent."""

import numpy as np
import pytest

import lstm_unet_tpu.io.tiff as tiff


@pytest.fixture
def no_cv2_pil(monkeypatch):
    import sys

    for mod in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)  # import raises
    monkeypatch.setattr(tiff, "_cv2", None)
    monkeypatch.setattr(tiff, "_pil", None)
    monkeypatch.setattr(tiff, "_native", False)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_numpy_tiff_round_trip_without_cv2_or_pil(tmp_path, dtype, no_cv2_pil):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, np.iinfo(dtype).max, (37, 53)).astype(dtype)
    p = str(tmp_path / "sub" / "x.tif")
    tiff.write_tiff(p, arr)
    back = tiff.read_tiff(p)
    assert back.dtype == dtype and back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)
    # a compressed file it cannot decode raises a clear error
    with open(p, "r+b") as f:
        data = bytearray(f.read())
    ifd = int.from_bytes(data[4:8], "little")
    n = int.from_bytes(data[ifd:ifd + 2], "little")
    for i in range(n):  # flip Compression (tag 259) to LZW (5)
        e = ifd + 2 + 12 * i
        if int.from_bytes(data[e:e + 2], "little") == 259:
            data[e + 8:e + 10] = (5).to_bytes(2, "little")
    with open(p, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(RuntimeError, match="compressed"):
        tiff.read_tiff(p)
