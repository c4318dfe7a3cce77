"""On-device instance-segmentation postprocess.

Reference parity: the per-frame host postprocess of ``Inference2D.py``
(SURVEY.md §3.2): threshold interior probability → connected components →
drop blobs < min_cell_size → grow labels into the boundary band → FOV border
rule → uint16 instance map. The reference does this in numpy/cv2 with a
GPU→CPU sync per frame; here the whole chain is one jitted device function
(BASELINE.json: "softmax, thresholding, and connected-component instance
labeling run on-device").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .ccl import (connected_components, connected_components_scan,
                  relabel_compact, relabel_compact_mm)


_INT_MAX = jnp.iinfo(jnp.int32).max


def _neighbor_max(lbl: jax.Array) -> jax.Array:
    p = jnp.pad(lbl, 1, constant_values=0)
    h, w = lbl.shape
    out = lbl
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out = jnp.maximum(out, jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (h, w)))
    return out


def _neighbor_min_nonzero(lbl: jax.Array) -> jax.Array:
    """Min nonzero label over the 8-neighborhood (_INT_MAX where none)."""
    masked = jnp.where(lbl > 0, lbl, _INT_MAX)
    p = jnp.pad(masked, 1, constant_values=_INT_MAX)
    h, w = lbl.shape
    out = jnp.full_like(lbl, _INT_MAX)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out = jnp.minimum(out, jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (h, w)))
    return out


def grow_into_band(lbl: jax.Array, band: jax.Array, max_rounds: int = 0
                   ) -> jax.Array:
    """Marker-based region growth: expand instance labels into ``band``
    pixels until the band is exhausted (early-exit while_loop).

    All markers advance one pixel per round (simultaneous BFS), so each band
    pixel is claimed by its geodesically NEAREST marker — the watershed-style
    assignment of the reference's boundary handling (SURVEY.md §2 "Inference
    driver" [M]). Simultaneous arrivals tie-break to the smaller (raster-
    first) label, deterministically. ``max_rounds > 0`` caps the growth
    radius; 0 grows to exhaustion.
    """
    h, w = lbl.shape
    bound = max_rounds if max_rounds > 0 else h * w  # geodesic worst case

    def cond(state):
        _, changed, it = state
        return changed & (it < bound)

    def body(state):
        cur, _, it = state
        nb = _neighbor_min_nonzero(cur)
        new = jnp.where((cur == 0) & band & (nb != _INT_MAX), nb, cur)
        return new, jnp.any(new != cur), it + 1

    lbl, _, _ = jax.lax.while_loop(cond, body, (lbl, jnp.bool_(True), jnp.int32(0)))
    return lbl


def _erode(mask: jax.Array, connectivity: int = 8) -> jax.Array:
    """Binary erosion (8- or 4-neighborhood); the image border counts as
    background (cells clipped by the frame edge erode from the edge too)."""
    p = jnp.pad(mask, 1, constant_values=False)
    h, w = mask.shape
    out = mask
    shifts = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    if connectivity == 8:
        shifts += [(1, 1), (1, -1), (-1, 1), (-1, -1)]
    for dy, dx in shifts:
        out = out & jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (h, w))
    return out


def chebyshev_distance(mask: jax.Array, max_iters: int = 0) -> jax.Array:
    """Chebyshev (8-connected) distance to background for each mask pixel
    (0 outside the mask, 1 on the component border) via iterated erosion —
    an early-exit while_loop of cheap elementwise shift/and ops, O(max cell radius)
    rounds. ``max_iters`` caps the rounds (0 = until the mask erodes away)."""
    return _erosion_distance(mask, max_iters, octagon=False)


def octagon_distance(mask: jax.Array, max_iters: int = 0) -> jax.Array:
    """Octagonal distance to background: alternating 8-/4-neighborhood
    erosion. Within ~8% of Euclidean in every direction — unlike Chebyshev,
    which under-measures round-cell peaks by 1/sqrt(2) (diagonal) while
    measuring axis-aligned necks exactly, systematically inflating
    neck/peak ratios and defeating relative marker suppression (measured:
    two touching discs r=20/18 read neck/peak 11/15 in Chebyshev but 10/18
    octagonal). The marker stage of instance splitting uses this metric."""
    return _erosion_distance(mask, max_iters, octagon=True)


def _erosion_distance(mask: jax.Array, max_iters: int, octagon: bool
                      ) -> jax.Array:
    h, w = mask.shape
    mask = mask.astype(bool)
    bound = max_iters or max(h, w)

    def cond(state):
        m, _, it = state
        return jnp.any(m) & (it < bound)

    def body(state):
        m, d, it = state
        if octagon:  # 8,4,8,4,... = octagon norm
            m2 = jax.lax.cond(it % 2 == 0,
                              lambda x: _erode(x, 8), lambda x: _erode(x, 4),
                              m)
        else:
            m2 = _erode(m, 8)
        return m2, d + m2.astype(jnp.int32), it + 1

    _, dist, _ = jax.lax.while_loop(
        cond, body, (mask, mask.astype(jnp.int32), jnp.int32(0)))
    return dist


def split_touching_instances(lbl: jax.Array, interior: jax.Array,
                             window: int = 16, min_dist: int = 4,
                             slack: int = 1, rel: float = 0.65,
                             rel_window: int = 48, min_size: int = 0
                             ) -> jax.Array:
    """Partition merged components of touching cells along their distance
    ridge (SURVEY.md §3.2 watershed-style postprocess [M], at its real
    intent: separating touching cells; VERDICT r2 task #1).

    Markers are the regional maxima of the Chebyshev distance transform of
    ``interior`` — pixels within ``slack`` of their ``(2*window+1)²`` window
    max and at least ``min_dist`` from background (suppresses rim/noise
    maxima). Two further guards against OVERsplitting (each measured on the
    512² held-out oracle, where naive window=8 markers scored 0.917 ->
    0.764):

    - ``slack`` (h-maxima tolerance): accept pixels within ``slack`` of the
      window max, bridging the integer DT's terrace steps into one marker
      component; a saddle between two real touching cells drops by more
      than ``slack`` per window and still separates.
    - ``rel`` / ``rel_window``: a marker must also reach ``rel`` × the
      window max over the LARGER ``rel_window`` neighborhood — an
      occlusion crescent/dumbbell lobe whose peak is much lower than the
      dominant peak nearby is suppressed (absorbed by the dominant marker,
      i.e. graceful degradation to no-split), while two comparable touching
      cells both survive. 0 disables.
    - ``min_size``: only components at least this many pixels are ELIGIBLE
      for splitting (smaller ones keep their original label untouched). A
      merged pair of cells is ~2x a single cell's area while the
      occlusion crescents that oversplit are normal-sized or smaller, so a
      threshold between the two applies splitting exactly where merges can
      exist. 0 disables.

    Each
    marker plateau is one CCL seed; seeds then claim the whole interior by
    simultaneous-BFS nearest-marker growth (:func:`grow_into_band`), so a
    merged blob of N touching cells with N distance maxima splits along the
    equidistant ridge between them. A component with a single maximum is
    reproduced exactly (all its pixels reach its one marker). Components
    with NO marker (everywhere closer than ``min_dist`` to background) keep
    their ORIGINAL label: growth cannot cross background, so per-pixel
    fallback equals per-component fallback; seed ids are min linear pixel
    indices of disjoint pixel sets (markers vs marker-less components) and
    therefore never collide.

    ``lbl`` must be the raw (or compact) CCL labeling of ``interior``;
    returns a new int32 labeling of the same support, ids NOT compact —
    follow with the relabel/size-filter pass.
    """
    dist = octagon_distance(interior)
    wmax = dist
    wide = dist
    for i in range(max(window, rel_window if rel > 0 else 0)):
        wide = _neighbor_max(wide)
        if i + 1 == window:
            wmax = wide
    markers = interior & (dist >= wmax - slack) & (dist >= min_dist)
    if rel > 0:
        markers &= dist.astype(jnp.float32) >= rel * wide.astype(jnp.float32)
    if min_size > 0:
        # per-pixel component size; ineligible components get NO markers so
        # the marker-less fallback below keeps their labels bit-identical
        h, w = lbl.shape
        n = h * w + 1
        counts = jnp.zeros((n,), jnp.int32).at[lbl.reshape(-1)].add(1)
        comp_size = counts[lbl.reshape(-1)].reshape(h, w)
        markers &= comp_size >= min_size
    seeds = connected_components(markers, connectivity=8)
    grown = grow_into_band(seeds, interior, max_rounds=0)
    return jnp.where(grown > 0, grown, jnp.where(lbl > 0, lbl, 0))


def split_touching_instances_prob(lbl: jax.Array, interior: jax.Array,
                                  p_cell: jax.Array, hi_thresh: float = 0.8,
                                  erode_iters: int = 1, min_size: int = 0
                                  ) -> jax.Array:
    """Partition merged components along the MODEL'S OWN internal evidence
    (hysteresis two-threshold split) instead of mask geometry.

    The offline geometry sweep measured the distance-ridge splitter negative
    across its entire 36-config grid (BASELINE.md session 6): the merges the
    model makes are one smooth blob in the distance transform, while DT
    markers fire on dumbbell-shaped TRUE cells. But a merge happens where the
    boundary class FADED — p(cell) typically still dips below its in-cell
    plateau along the missed boundary even when it wins the argmax. So:
    markers = ``interior & (p_cell >= hi_thresh)``, eroded ``erode_iters``
    times (kills one-/two-px bridges across the dip and noise islands), one
    CCL seed per marker component, then the same simultaneous-BFS
    nearest-marker growth over the interior as the DT splitter.

    Degradation properties (mirror the DT splitter's contracts):

    - A component with uniformly high confidence (no internal dip below
      ``hi_thresh``) yields ONE marker and is reproduced exactly — the
      splitter only fires where the model itself hesitated.
    - A component whose p(cell) never reaches ``hi_thresh`` (or erodes
      away) has NO marker and keeps its ORIGINAL label bit-identically
      (growth cannot cross background).
    - ``min_size``: only components at least this many pixels are eligible,
      same economics as the DT splitter (merged pairs are ~2x cell area).

    ``lbl`` must be a CCL labeling of ``interior``; returns int32 labels of
    the same support, ids NOT compact — follow with the relabel pass.
    """
    markers = interior & (p_cell >= hi_thresh)
    for _ in range(erode_iters):
        markers = _erode(markers, connectivity=8)
    if min_size > 0:
        h, w = lbl.shape
        n = h * w + 1
        counts = jnp.zeros((n,), jnp.int32).at[lbl.reshape(-1)].add(1)
        comp_size = counts[lbl.reshape(-1)].reshape(h, w)
        markers &= comp_size >= min_size
    seeds = connected_components(markers, connectivity=8)
    grown = grow_into_band(seeds, interior, max_rounds=0)
    return jnp.where(grown > 0, grown, jnp.where(lbl > 0, lbl, 0))


# relabel_method='auto' per platform. 'matmul' replaces the scatter-add
# histogram and the random gather over the h*w+1 seed table with one-hot
# matmuls (bit-identical below 65536 instances, ALL-int32-max above — the
# byte-split cannot represent larger ids and the output contract is uint16
# anyway); it pays only where random access is slow and matrix units are
# fast. On the H100 the scatter path took 0.180 ms and the matmul path
# 4.357 ms for a 512² frame of 40 cells (PERF.md, bring-up), and on the CPU
# the dense contraction is far slower too, so both take 'scatter'.
AUTO_RELABEL = {"cpu": "scatter", "gpu": "scatter"}


def resolve_relabel_method(method: str, platform: str | None = None) -> str:
    """'auto' -> the measured choice for ``platform`` (default: JAX's
    default backend); other methods pass through."""
    if method != "auto":
        return method
    platform = platform or jax.default_backend()
    if platform not in AUTO_RELABEL:
        raise ValueError(f"relabel_method='auto' has no measured choice for "
                         f"platform {platform!r}; pass 'scatter' or 'matmul'")
    return AUTO_RELABEL[platform]


@functools.partial(
    jax.jit,
    static_argnames=("cell_thresh", "edge_thresh", "min_cell_size",
                     "max_cell_size", "size_filter", "fov",
                     "boundary_growth", "grow_iters",
                     "ccl_method", "relabel_method",
                     "instance_split", "split_method",
                     "split_window", "split_min_dist", "split_slack",
                     "split_rel", "split_rel_window", "split_min_size",
                     "split_hi_thresh", "split_erode"),
)
def postprocess_frame(
    probs: jax.Array,
    cell_thresh: float = 0.5,
    edge_thresh: float = 0.3,
    min_cell_size: int = 10,
    max_cell_size: int = 0,
    size_filter: str = "pre",
    fov: int = 0,
    boundary_growth: str = "marker",
    grow_iters: int = 0,
    ccl_method: str = "sweep",
    relabel_method: str = "auto",
    instance_split: bool = False,
    split_method: str = "dist",
    split_window: int = 16,
    split_min_dist: int = 4,
    split_slack: int = 1,
    split_rel: float = 0.65,
    split_rel_window: int = 48,
    split_min_size: int = 0,
    split_hi_thresh: float = 0.8,
    split_erode: int = 1,
) -> jax.Array:
    """3-class probabilities [H,W,3] → instance labels [H,W] int32.

    Steps (reference order, SURVEY.md §3.2 [M]):
      1. interior mask  = p(cell) > cell_thresh
      2. 8-connected components on interior
      2b. optional ``instance_split``: partition merged components of
          touching cells — ``split_method='dist'`` along distance-transform
          ridges (:func:`split_touching_instances`), ``'prob'`` along the
          model's own confidence dips
          (:func:`split_touching_instances_prob`) — default off for
          reference parity
      3. drop components outside [min_cell_size, max_cell_size].
         ``size_filter='post'`` instead measures sizes AFTER step 4's
         growth (interior + grown band): an occlusion crescent whose
         visible interior is tiny still seeds growth and is kept if its
         grown extent clears the bar — the oracle attributes 0.031 SEG
         of its ceiling to such absorbed crescents (BASELINE.md r3).
         Default 'pre' is the reference order [M].
      4. grow surviving labels into the boundary band (pixels with
         p(boundary) > edge_thresh): ``boundary_growth='marker'`` (default)
         is nearest-marker growth to band exhaustion (reference's
         marker-based region growth [M]); ``'dilate'`` is fixed-round
         max-label dilation; ``'none'`` skips growth. ``grow_iters`` caps
         the rounds (0 = exhaustion for 'marker', 3 for 'dilate').
      5. FOV rule: remove instances that never touch the interior region
         `fov` pixels in from every image border [M]
      6. compact to 1..N in raster order (cv2.connectedComponents order)
    """
    probs = probs.astype(jnp.float32)
    h, w = probs.shape[0], probs.shape[1]
    interior = probs[..., 1] > cell_thresh
    if ccl_method == "scan":
        # run-propagation sweeps (segmented min-scans): bit-identical,
        # fewer iterations on large blobs — A/B option (CLAUDE.md: fused
        # end-to-end A/B before any default flip)
        raw = connected_components_scan(interior, connectivity=8)
    else:
        raw = connected_components(interior, connectivity=8)
    if instance_split:
        if split_method == "prob":
            raw = split_touching_instances_prob(
                raw, interior, probs[..., 1], hi_thresh=split_hi_thresh,
                erode_iters=split_erode, min_size=split_min_size)
        elif split_method == "dist":
            raw = split_touching_instances(raw, interior, window=split_window,
                                           min_dist=split_min_dist,
                                           slack=split_slack, rel=split_rel,
                                           rel_window=split_rel_window,
                                           min_size=split_min_size)
        else:
            raise ValueError(f"unknown split_method {split_method!r}")
    relabel_method = resolve_relabel_method(relabel_method)
    if size_filter not in ("pre", "post"):
        raise ValueError(f"unknown size_filter {size_filter!r}")
    # 'post': compact only here; measure sizes on the GROWN labels below
    pre_min = 0 if size_filter == "post" else min_cell_size
    pre_max = 0 if size_filter == "post" else max_cell_size
    if relabel_method == "matmul":
        lbl, _n1 = relabel_compact_mm(raw, min_size=pre_min,
                                      max_size=pre_max)
        overflowed = _n1 > 65535
    elif relabel_method == "scatter":
        lbl, _n1 = relabel_compact(raw, min_size=pre_min,
                                   max_size=pre_max)
        # the scatter FOV pass below clamps ids into 65536 bins (silently
        # merging instances past the uint16 contract) — poison that case
        # loudly too, symmetric with the matmul branch
        overflowed = _n1 > 65535
    else:
        raise ValueError(f"unknown relabel_method {relabel_method!r}")

    if boundary_growth == "marker":
        band = (probs[..., 2] > edge_thresh) & ~interior
        lbl = grow_into_band(lbl, band, max_rounds=grow_iters)
    elif boundary_growth == "dilate":
        band = (probs[..., 2] > edge_thresh) & ~interior
        rounds = grow_iters if grow_iters > 0 else 3
        def grow(_, cur):
            return jnp.where((cur == 0) & band, _neighbor_max(cur), cur)
        lbl = jax.lax.fori_loop(0, rounds, grow, lbl)
    elif boundary_growth != "none":
        raise ValueError(f"unknown boundary_growth {boundary_growth!r}")

    if size_filter == "post":
        # size filter + recompact on the grown extent (one extra relabel
        # pass, ~2.3 ms @512² matmul — opt-in)
        if relabel_method == "matmul":
            lbl, _n2 = relabel_compact_mm(lbl, min_size=min_cell_size,
                                          max_size=max_cell_size)
        else:
            lbl, _n2 = relabel_compact(lbl, min_size=min_cell_size,
                                       max_size=max_cell_size)
        overflowed |= _n2 > 65535

    if fov > 0:
        rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        inside = ((rows >= fov) & (rows < h - fov) & (cols >= fov) & (cols < w - fov))
        if relabel_method == "matmul":
            # scatter/gather-free FOV in ONE histogram + ONE lookup: a label
            # survives iff it touches the inside region, so the compact ids
            # derive directly from the touches histogram (keep + raster
            # cumsum) and a single mm_lookup both filters (dropped -> 0)
            # and renumbers
            from .ccl import compact_ids_from_keep, mm_histogram, mm_lookup

            touches = mm_histogram(jnp.where(inside, lbl, 0))
            keep2d = (touches > 0).at[0, 0].set(False)
            lbl = mm_lookup(lbl, compact_ids_from_keep(keep2d))
        else:
            # labels are compact 1..N here (first relabel pass), and the
            # engine's output contract is uint16 instances — 65536 bins
            # suffice and cut the scatter table + cumsum 4x vs h*w+1 @512^2
            n = min(h * w + 1, 65536)
            touches = jnp.zeros((n,), jnp.int32).at[
                jnp.minimum(jnp.where(inside, lbl, 0), n - 1).reshape(-1)
            ].add(1)
            keep_mask = (touches > 0).at[0].set(False)
            lbl = jnp.where(keep_mask[jnp.minimum(lbl, n - 1).reshape(-1)
                                      ].reshape(h, w), lbl, 0)
            lbl, _ = relabel_compact(lbl, num_bins=n)
        # when fov == 0 the labels are already compact 1..N from the
        # min-size pass (growth adds no ids), so the second relabel pass is
        # skipped entirely
    # >65535 surviving instances: mm byte-split ids (and the scatter FOV
    # bin clamp) are invalid past the uint16 output contract — poison the
    # whole map so the engine's labels.max() guard raises instead of
    # shipping silently wrong ids
    lbl = jnp.where(overflowed, jnp.int32(_INT_MAX), lbl)
    return lbl
