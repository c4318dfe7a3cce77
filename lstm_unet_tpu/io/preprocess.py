"""Preprocessing: percentile normalization, instance→3-class GT, padding.

Reference parity (SURVEY.md §2 "Training reader"/"Inference reader"):
- percentile-based intensity normalization [H — BASELINE.json]
- instance SEG GT → 3 classes (background / cell interior / cell boundary)
  via per-label morphology [M]; here vectorized as a neighbor-disagreement
  test (equivalent to a 3x3 erosion-based boundary)
- reflect-pad each frame to a multiple of 2^depth before inference [M]

The normalize path is jittable so it can fuse into the on-device pipeline
(BASELINE.json: "TIFF decode, percentile normalization ... become an
on/near-device jit preprocessing pipeline").
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


# --------------------------------------------------------------------------
# Percentile normalization
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("low", "high"))
def percentile_normalize(img: jax.Array, low: float = 1.0, high: float = 99.0) -> jax.Array:
    """Normalize intensities to ~[0,1] between the low/high percentiles.

    Jittable, on-device. Percentiles computed per-image over all pixels.
    Reference: DataHandeling.py normalization [H — BASELINE.json].
    """
    x = img.astype(jnp.float32)
    flat = x.reshape(-1)
    lo = jnp.percentile(flat, low)
    hi = jnp.percentile(flat, high)
    scale = jnp.maximum(hi - lo, 1e-6)
    return (x - lo) / scale


def integer_percentile_bounds(x: jax.Array, low: float = 1.0,
                              high: float = 99.0):
    """Exact (low, high) percentiles of an INTEGER image in [0, 65535] —
    bit-identical to ``jnp.percentile(x.astype(f32), ...)`` (tested) but
    computed from a 65536-bin one-hot-matmul histogram + cumsum +
    searchsorted instead of a full 512² sort. A histogram quantile is
    silently wrong for float inputs — dispatching on the integer dtype
    (static under jit) removes that hazard entirely. Order
    statistics of integers are exact in either method, and the final linear
    interpolation uses the same f32 arithmetic as jnp.percentile."""
    from ..ops.ccl import mm_histogram_u16

    counts = mm_histogram_u16(x).reshape(-1)
    csum = jnp.cumsum(counts)
    n = x.size

    def pct(q):
        pos = jnp.float32(q / 100.0) * (n - 1)
        k = jnp.floor(pos).astype(jnp.int32)
        frac = pos - k.astype(jnp.float32)
        lo_v = jnp.searchsorted(csum, k + 1, side="left").astype(jnp.float32)
        hi_v = jnp.searchsorted(csum, jnp.minimum(k + 2, n),
                                side="left").astype(jnp.float32)
        return lo_v * (1.0 - frac) + hi_v * frac

    return pct(low), pct(high)


def percentile_normalize_np(img: np.ndarray, low: float = 1.0, high: float = 99.0) -> np.ndarray:
    """NumPy twin of :func:`percentile_normalize` (host pipeline / tests)."""
    x = img.astype(np.float32)
    lo = np.percentile(x, low)
    hi = np.percentile(x, high)
    return (x - lo) / max(hi - lo, 1e-6)


# --------------------------------------------------------------------------
# Instance GT → 3-class (bg=0 / interior=1 / boundary=2)
# --------------------------------------------------------------------------


def instance_to_three_class(labels: np.ndarray, boundary_width: int = 1) -> np.ndarray:
    """Convert an instance-labeled mask to {0:bg, 1:interior, 2:boundary}.

    A labeled pixel is *boundary* if any pixel within a (2w+1)^2 neighborhood
    carries a different label (including background). This equals the
    reference's per-label erosion with a 3x3 structuring element for w=1
    (SURVEY.md §2 "Training reader" [M]) but runs vectorized in one pass
    instead of per-label morphology.
    """
    lab = labels.astype(np.int32)
    fg = lab > 0
    boundary = np.zeros_like(fg)
    h, w = lab.shape
    padded = np.pad(lab, boundary_width, mode="edge")
    for dy in range(-boundary_width, boundary_width + 1):
        for dx in range(-boundary_width, boundary_width + 1):
            if dy == 0 and dx == 0:
                continue
            neigh = padded[
                boundary_width + dy : boundary_width + dy + h,
                boundary_width + dx : boundary_width + dx + w,
            ]
            boundary |= fg & (neigh != lab)
    out = np.zeros(lab.shape, dtype=np.uint8)
    out[fg] = 1
    out[boundary] = 2
    return out


def instance_to_three_class_jax(labels: jax.Array, boundary_width: int = 1) -> jax.Array:
    """Jittable twin of :func:`instance_to_three_class` (device pipeline)."""
    lab = labels.astype(jnp.int32)
    fg = lab > 0
    pad = boundary_width
    padded = jnp.pad(lab, pad, mode="edge")
    h, w = lab.shape
    boundary = jnp.zeros_like(fg)
    for dy in range(-pad, pad + 1):
        for dx in range(-pad, pad + 1):
            if dy == 0 and dx == 0:
                continue
            neigh = jax.lax.dynamic_slice(padded, (pad + dy, pad + dx), (h, w))
            boundary = boundary | (fg & (neigh != lab))
    return jnp.where(boundary, 2, jnp.where(fg, 1, 0)).astype(jnp.uint8)


# --------------------------------------------------------------------------
# Padding
# --------------------------------------------------------------------------


def pad_to_multiple(img: np.ndarray, multiple: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Reflect-pad H,W (leading dims untouched) up to a multiple of `multiple`.

    Returns (padded, (pad_h, pad_w)). Reference: Inference2D.py pads each frame
    to a multiple of 2^depth with reflect padding [M].
    """
    h, w = img.shape[-2], img.shape[-1]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph == 0 and pw == 0:
        return img, (0, 0)
    pad = [(0, 0)] * (img.ndim - 2) + [(0, ph), (0, pw)]
    return np.pad(img, pad, mode="reflect"), (ph, pw)
