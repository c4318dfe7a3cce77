"""On-device connected-component labeling (CCL).

Reference parity: ``Inference2D.py`` runs ``cv2.connectedComponents`` on the
host per frame — a GPU→CPU sync per frame, flagged in SURVEY.md §3.2 as the
reference's biggest perf sink. BASELINE.json requires CCL on-device.

Algorithm: iterative min-label propagation (SURVEY.md §7 hard-part #1).
Seeds are linear indices (+1); each round every foreground pixel takes the
min label over its 8-neighborhood (matching cv2's default 8-connectivity);
a `lax.while_loop` runs to a fixed point with an iteration bound. The
converged label of a component is its minimum seed = raster-order-first
pixel, so compacted labels come out in the same raster order cv2 assigns.

Each propagation round is a handful of cheap elementwise shift/min ops on
a [H, W] i32 grid — bandwidth-trivial at 512²; the fixed point is reached in
O(component diameter) rounds (we sweep 4 rounds per convergence check to
amortize the reduction).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

_INF = jnp.iinfo(jnp.int32).max


def _neighbor_min(lbl: jax.Array, connectivity: int) -> jax.Array:
    """Min over the 4- or 8-neighborhood, edges padded with +inf."""
    p = jnp.pad(lbl, 1, constant_values=_INF)
    h, w = lbl.shape
    shifts = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    if connectivity == 8:
        shifts += [(1, 1), (1, -1), (-1, 1), (-1, -1)]
    out = lbl
    for dy, dx in shifts:
        out = jnp.minimum(out, jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (h, w)))
    return out


@functools.partial(jax.jit, static_argnames=("connectivity", "max_iters"))
def connected_components(mask: jax.Array, connectivity: int = 8,
                         max_iters: int = 0) -> jax.Array:
    """Label a binary mask [H,W] → int32 labels (0 = background).

    Labels are component-min linear indices + 1 (NOT compact); feed through
    :func:`relabel_compact` for 1..N raster-ordered ids.
    """
    h, w = mask.shape
    mask = mask.astype(bool)
    idx = (jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) * w
           + jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) + 1)
    lbl0 = jnp.where(mask, idx, _INF)
    # worst-case geodesic diameter is O(h*w) (snake/spiral components) —
    # a h+w bound silently fragments such components; the early-exit keeps
    # typical cell masks at O(cell diameter) sweeps regardless of the bound
    bound = max_iters or (h * w)

    def cond(state):
        lbl, changed, it = state
        return changed & (it < bound)

    def body(state):
        lbl, _, it = state
        new = lbl
        for _ in range(4):  # several sweeps per convergence check
            new = jnp.where(mask, jnp.minimum(new, _neighbor_min(new, connectivity)), _INF)
        return new, jnp.any(new != lbl), it + 4

    lbl, _, _ = jax.lax.while_loop(cond, body, (lbl0, jnp.bool_(True), jnp.int32(0)))
    return jnp.where(mask, lbl, 0).astype(jnp.int32)


def _segmented_min_scan(lbl: jax.Array, mask: jax.Array) -> jax.Array:
    """Per-row forward+backward segmented min: within every contiguous
    foreground RUN of each row, every pixel takes the run's min label —
    one associative_scan pair (log-depth) instead of O(run length)
    neighbor sweeps. Background pixels keep _INF."""
    starts = jnp.concatenate(
        [jnp.ones((lbl.shape[0], 1), bool), ~mask[:, :-1]], axis=1)

    def op(a, b):
        av, ag = a
        bv, bg = b
        return jnp.where(bg, bv, jnp.minimum(av, bv)), ag | bg

    fwd, _ = jax.lax.associative_scan(op, (lbl, starts), axis=1)
    rstarts = jnp.concatenate(
        [jnp.ones((lbl.shape[0], 1), bool), ~mask[:, 1:][:, ::-1]], axis=1)
    bwd, _ = jax.lax.associative_scan(op, (lbl[:, ::-1], rstarts), axis=1)
    out = jnp.minimum(fwd, bwd[:, ::-1])
    return jnp.where(mask, out, _INF)


@functools.partial(jax.jit, static_argnames=("connectivity", "max_iters"))
def connected_components_scan(mask: jax.Array, connectivity: int = 8,
                              max_iters: int = 0) -> jax.Array:
    """:func:`connected_components` with run-propagation sweeps: each round
    does a row segmented-min scan, a column segmented-min scan (transposed
    row scan) and one 8-neighbor min — labels cross an entire straight run
    per round instead of one pixel, so convergence is O(component
    "turns"), not O(diameter). Same fixed point (the component min seed),
    bit-identical output; kept as a separate entry point for A/B."""
    h, w = mask.shape
    mask = mask.astype(bool)
    idx = (jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) * w
           + jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) + 1)
    lbl0 = jnp.where(mask, idx, _INF)
    bound = max_iters or (h * w)

    def cond(state):
        lbl, changed, it = state
        return changed & (it < bound)

    def body(state):
        lbl, _, it = state
        new = _segmented_min_scan(lbl, mask)
        new = _segmented_min_scan(new.T, mask.T).T
        new = jnp.where(mask, jnp.minimum(new, _neighbor_min(new, connectivity)),
                        _INF)
        return new, jnp.any(new != lbl), it + 1

    lbl, _, _ = jax.lax.while_loop(cond, body, (lbl0, jnp.bool_(True),
                                                jnp.int32(0)))
    return jnp.where(mask, lbl, 0).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("min_size", "max_size",
                                             "num_bins"))
def relabel_compact(labels: jax.Array, min_size: int = 0, max_size: int = 0,
                    num_bins: int = 0) -> Tuple[jax.Array, jax.Array]:
    """Compact sparse labels to 1..N (raster order), dropping size outliers.

    Reference parity: the `min_cell_size` filter of Inference2D.py [M].
    Returns (compact_labels int32 [H,W], num_components int32 scalar).

    ``num_bins`` bounds the histogram when the caller KNOWS labels are
    already compact (e.g. ≤65535 instances, the uint16 output contract) —
    shrinks the scatter table and cumsum from h*w+1 to num_bins.
    """
    h, w = labels.shape
    n = num_bins or (h * w + 1)
    idx = labels.reshape(-1)
    if num_bins:
        idx = jnp.minimum(idx, n - 1)  # OOB-safe; caller guarantees range
    counts = jnp.zeros((n,), jnp.int32).at[idx].add(1)
    keep = counts > 0
    keep = keep.at[0].set(False)
    if min_size:
        keep &= counts >= min_size
    if max_size:
        keep &= counts <= max_size
    new_ids = jnp.cumsum(keep.astype(jnp.int32)) * keep  # 0 where dropped
    out = new_ids[idx].reshape(h, w).astype(jnp.int32)
    return out, jnp.max(new_ids).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("min_size", "max_size"))
def relabel_compact_mm(labels: jax.Array, min_size: int = 0,
                       max_size: int = 0) -> Tuple[jax.Array, jax.Array]:
    """Scatter/gather-free :func:`relabel_compact` (same contract).

    Replaces the scatter-add histogram and the random gather over the h*w+1
    seed table with dense one-hot matrix products, for devices where random
    access is slow and matrix units are fast:

    - histogram: seed value s = hi*w + lo decomposes into (hi, lo); counts
      over the 2-D bin grid are ``one_hot(hi)^T @ one_hot(lo)`` summed over
      pixel chunks — 0/1 bf16 matmuls with f32 accumulation are EXACT
      (~137 GFLOP @512²);
    - compaction ids: raster cumsum over the bin grid = per-row cumsum +
      row-offset prefix (cheap 2-D pass, not a 262k 1-D scan);
    - remap: ``new_ids[seed_p]`` gathers become two more one-hot matmuls
      against the id table split into high/low bytes (ids ≤ 65535 — the
      uint16 output contract — keep each byte ≤ 255, exact in bf16).

    Id overflow is LOUD: if more than 65535 components survive the filters
    (beyond the byte-split's exact range AND the uint16 output contract),
    every pixel of the returned map is set to int32 max — callers that cast
    to uint16 (the engine checks ``labels.max()``) fail immediately instead
    of shipping silently corrupted ids. The returned count is always exact.

    Any (h, w): rows are zero-padded internally to the chunk multiple
    (padding only inflates the background bin, which is never kept).
    """
    counts = mm_histogram(labels)
    keep = counts > 0
    keep = keep.at[0, 0].set(False)  # background bin (label 0)
    if min_size:
        keep &= counts >= min_size
    if max_size:
        keep &= counts <= max_size

    new_ids = compact_ids_from_keep(keep)
    out = mm_lookup(labels, new_ids)
    n = jnp.max(new_ids).astype(jnp.int32)
    out = jnp.where(n > 65535, jnp.int32(jnp.iinfo(jnp.int32).max), out)
    return out, n


_MM_CH = 16  # pixel rows per scan step


def _mm_split(values: jax.Array):
    """[h,w] int32 in [0, h*w] -> chunked (hi, lo) bin coords + bin axes.

    Rows are zero-padded to a multiple of the chunk size (e.g. real CTC
    frame heights like 690): padded pixels carry value 0 and land in the
    background bin (0, 0), which every caller excludes."""
    h, w = values.shape
    hp = h + (-h) % _MM_CH
    if hp != h:
        values = jnp.pad(values, ((0, hp - h), (0, 0)))
    hi = (values // w).reshape(hp // _MM_CH, _MM_CH * w)
    lo = (values % w).reshape(hp // _MM_CH, _MM_CH * w)
    bins_h = jnp.arange(hp + 1, dtype=jnp.int32)  # value h*w has hi == h
    bins_w = jnp.arange(w, dtype=jnp.int32)
    return hi, lo, bins_h, bins_w, hp


def compact_ids_from_keep(keep: jax.Array) -> jax.Array:
    """keep [(hp+1), w] bool -> raster-ordered compact ids (0 where dropped):
    per-row cumsum + row-offset prefix (cheap 2-D pass, not a 1-D scan)."""
    k32 = keep.astype(jnp.int32)
    row_off = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(jnp.sum(k32, axis=1))[:-1]])
    return (jnp.cumsum(k32, axis=1) + row_off[:, None]) * k32


def mm_histogram(values: jax.Array) -> jax.Array:
    """Histogram of [h,w] int32 values in [0, h*w] -> counts [(hp+1), w]
    where hp is h padded to the chunk multiple (bin of value s =
    (s // w, s % w); row padding inflates only bin (0, 0)), computed as
    chunked ``one_hot(hi)^T @ one_hot(lo)`` matmuls — no scatter. 0/1
    bf16 operands with f32 accumulation are exact for counts < 2^24."""
    # f32 accumulation is exact only below 2^24 per bin; a single component
    # larger than ~16.7M pixels (frames beyond ~4096x4096) would silently
    # corrupt the size filters. Static shapes make this check free.
    if values.shape[0] * values.shape[1] >= 2 ** 24:
        raise ValueError(
            f"mm_histogram: frame {values.shape} has >= 2^24 pixels; f32 "
            "accumulation would be inexact — use relabel_method='scatter'")
    hi, lo, bins_h, bins_w, hp = _mm_split(values)
    w = values.shape[1]

    def body(c2d, rows):
        hi_r, lo_r = rows
        a = (hi_r[:, None] == bins_h[None, :]).astype(jnp.bfloat16)
        b = (lo_r[:, None] == bins_w[None, :]).astype(jnp.bfloat16)
        return c2d + jnp.dot(a.T, b, preferred_element_type=jnp.float32), 0

    c2d, _ = jax.lax.scan(body, jnp.zeros((hp + 1, w), jnp.float32), (hi, lo))
    return c2d.astype(jnp.int32)


def mm_histogram_u16(values: jax.Array) -> jax.Array:
    """Histogram of values in [0, 65535] -> counts [256, 256] (bin of v =
    (v >> 8, v & 255), raster order == value order) via chunked one-hot
    matmuls — the scatter-free histogram trick applied to the uint16 value
    domain (exact: 0/1 bf16 operands, f32 accumulation, counts < 2^24).
    Used by the exact integer percentile normalization
    (io/preprocess.py::integer_percentile_bounds)."""
    v = values.reshape(-1).astype(jnp.int32)
    n = v.shape[0]
    if n >= 2 ** 24:
        raise ValueError(f"mm_histogram_u16: {n} values >= 2^24")
    ch = 8192
    pad = (-n) % ch
    if pad:
        # -1 sentinel: hi = -1 matches no bin, so padded lanes contribute 0
        v = jnp.concatenate([v, jnp.full((pad,), -1, jnp.int32)])
    hi = (v >> 8).reshape(-1, ch)
    lo = (v & 255).reshape(-1, ch)
    bins = jnp.arange(256, dtype=jnp.int32)

    def body(c, rows):
        hi_r, lo_r = rows
        a = (hi_r[:, None] == bins[None, :]).astype(jnp.bfloat16)
        b = (lo_r[:, None] == bins[None, :]).astype(jnp.bfloat16)
        return c + jnp.dot(a.T, b, preferred_element_type=jnp.float32), 0

    c, _ = jax.lax.scan(body, jnp.zeros((256, 256), jnp.float32), (hi, lo))
    return c.astype(jnp.int32)


def mm_lookup(values: jax.Array, table: jax.Array) -> jax.Array:
    """Per-pixel ``table[values // w, values % w]`` without random gathers:
    one-hot matmuls against the table split into high/low bytes (table
    entries must be int in [0, 65535] — exact per byte in bf16). ``table``
    must come from :func:`mm_histogram`-shaped bins ([(hp+1), w])."""
    h, w = values.shape
    hi, lo, bins_h, bins_w, hp = _mm_split(values)
    if table.shape != (hp + 1, w):
        raise ValueError(f"table shape {table.shape} != {(hp + 1, w)}")
    tb = jnp.concatenate([table >> 8, table & 255],
                         axis=1).astype(jnp.bfloat16)  # [(hp+1), 2w]

    def body(_, rows):
        hi_r, lo_r = rows
        a = (hi_r[:, None] == bins_h[None, :]).astype(jnp.bfloat16)
        t = jnp.dot(a, tb, preferred_element_type=jnp.float32)  # [CH*w, 2w]
        b = (lo_r[:, None] == bins_w[None, :]).astype(jnp.float32)
        hi8 = jnp.sum(t[:, :w] * b, axis=1)
        lo8 = jnp.sum(t[:, w:] * b, axis=1)
        return 0, (hi8 * 256.0 + lo8).astype(jnp.int32)

    _, out = jax.lax.scan(body, 0, (hi, lo))
    return out.reshape(hp, w)[:h]
