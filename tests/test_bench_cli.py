"""bench.py emission contract: one JSON line per run, naming its device.

MFU divides by the device's published peak from ``bench.PEAKS``; a device
missing from the table (the CPU here) is an error, never a default.
"""

import io
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _capture_stdout(fn):
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        fn()
    finally:
        sys.stdout = old
    return buf.getvalue()


def test_bench_train_mfu_emits_flops_and_mfu():
    """On the CPU the MFU path computes the step's FLOPs, then refuses to
    divide by a peak it does not know."""
    import bench

    with pytest.raises(ValueError, match="unknown device kind 'cpu'"):
        _capture_stdout(lambda: bench.bench_train(
            32, "float32", tiny=True, steps=1, emit=True, remat="none",
            B=1, T=1, mfu=True))


def test_bench_train_no_mfu_keys_by_default():
    import bench

    out = _capture_stdout(lambda: bench.bench_train(
        32, "float32", tiny=True, steps=1, emit=True, remat="none",
        B=1, T=1))
    d = json.loads([l for l in out.splitlines() if l.startswith("{")][-1])
    assert d["unit"] == "frames/sec" and d["value"] > 0
    assert d["device"] == {"platform": "cpu", "kind": "cpu", "count": 8}
    assert "train_flops_per_step" not in d
    assert "train_mfu" not in d


def test_peak_table_knows_the_h100():
    import bench

    assert bench.peak_rate("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert bench.peak_rate("NVIDIA H100 80GB HBM3", "int8") == 1979e12
    with pytest.raises(ValueError, match="unknown device kind"):
        bench.peak_rate("Unlisted Card", "bfloat16")
