"""Unit tests for the op layer (SURVEY.md §4 test plan).

- ConvLSTM cell vs a NumPy reference implementation of the gate math
- gradient of the gate update vs its analytic backward formula
- percentile normalization
- instance→3-class conversion
- CCL vs scipy.ndimage.label
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import scipy.ndimage as ndi

from lstm_unet_tpu.io.preprocess import (
    instance_to_three_class,
    instance_to_three_class_jax,
    percentile_normalize,
    percentile_normalize_np,
)
from lstm_unet_tpu.ops.ccl import connected_components, relabel_compact
from lstm_unet_tpu.ops.convlstm import ConvLSTMCell, lstm_gate_update_xla
from lstm_unet_tpu.ops.postprocess import postprocess_frame


# ---------------------------------------------------------------- ConvLSTM


def _numpy_convlstm_ref(x, h, c, kernel_x, kernel_h, bias,
                        recurrent_activation="sigmoid"):
    """Direct NumPy transcription of the Keras ConvLSTM2D gate math
    (separate input/recurrent kernels, SAME padding)."""
    from scipy.signal import correlate

    def conv(img, kernel):
        kh, kw, cin, cout = kernel.shape
        H, W = img.shape[:2]
        xp = np.pad(img, ((kh // 2, kh // 2), (kw // 2, kw // 2), (0, 0)))
        out = np.zeros((H, W, cout), np.float32)
        for o in range(cout):
            for i in range(cin):
                out[..., o] += correlate(xp[..., i], kernel[..., i, o],
                                         mode="valid")
        return out

    gates = conv(x, kernel_x) + conv(h, kernel_h) + bias
    F = c.shape[-1]
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    act = sig if recurrent_activation == "sigmoid" else (
        lambda v: np.clip(0.2 * v + 0.5, 0, 1))
    i_g = act(gates[..., 0 * F:1 * F])
    f_g = act(gates[..., 1 * F:2 * F])
    g_g = np.tanh(gates[..., 2 * F:3 * F])
    o_g = act(gates[..., 3 * F:4 * F])
    c_new = f_g * c + i_g * g_g
    h_new = o_g * np.tanh(c_new)
    return c_new, h_new


@pytest.mark.parametrize("recurrent_activation", ["sigmoid", "hard_sigmoid"])
def test_convlstm_cell_matches_numpy(recurrent_activation):
    key = jax.random.PRNGKey(0)
    B, H, W, Cin, F, K = 2, 8, 8, 3, 4, 3
    cell = ConvLSTMCell.init(key, K, Cin, F)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, H, W, Cin), jnp.float32)
    h0, c0 = ConvLSTMCell.init_state(B, H, W, F)
    h0 = h0 + jax.random.normal(jax.random.PRNGKey(2), h0.shape) * 0.1
    c0 = c0 + jax.random.normal(jax.random.PRNGKey(3), c0.shape) * 0.1

    (h1, c1), out = ConvLSTMCell.apply(
        cell, (h0, c0), x, recurrent_activation=recurrent_activation)
    np.testing.assert_allclose(out, h1)

    kernel_x = np.asarray(cell["kernel_x"])
    kernel_h = np.asarray(cell["kernel_h"])
    bias = np.asarray(cell["bias"])
    for b in range(B):
        c_ref, h_ref = _numpy_convlstm_ref(
            np.asarray(x[b]), np.asarray(h0[b]), np.asarray(c0[b]),
            kernel_x, kernel_h, bias, recurrent_activation)
        np.testing.assert_allclose(np.asarray(c1[b]), c_ref, atol=2e-4)
        np.testing.assert_allclose(np.asarray(h1[b]), h_ref, atol=2e-4)


def _gate_update_vjp_reference(gates, c, dc_out, dh, recurrent_activation):
    """Analytic backward of the ConvLSTM gate update, written out by hand:
    d(gates), d(c) from the cotangents of (c_new, h_new)."""
    feat = c.shape[-1]
    zi, zf, zg, zo = (gates[..., k * feat:(k + 1) * feat] for k in range(4))
    if recurrent_activation == "sigmoid":
        act = lambda z: 1.0 / (1.0 + np.exp(-z))  # noqa: E731
        dact = lambda z, a: a * (1.0 - a)  # noqa: E731
    else:  # hard_sigmoid: slope 0.2 inside the linear band, 0 outside
        act = lambda z: np.clip(0.2 * z + 0.5, 0.0, 1.0)  # noqa: E731
        dact = lambda z, a: np.where(  # noqa: E731
            (z > -2.5) & (z < 2.5), 0.2, 0.0)
    i, f, o = act(zi), act(zf), act(zo)
    cand = np.tanh(zg)
    c_new = f * c + i * cand
    tc = np.tanh(c_new)
    dc_new = dc_out + dh * o * (1.0 - tc * tc)
    d_zi = dc_new * cand * dact(zi, i)
    d_zf = dc_new * c * dact(zf, f)
    d_zo = dh * tc * dact(zo, o)
    d_zg = dc_new * i * (1.0 - cand * cand)
    return np.concatenate([d_zi, d_zf, d_zg, d_zo], axis=-1), dc_new * f


@pytest.mark.parametrize("recurrent_activation", ["sigmoid", "hard_sigmoid"])
def test_lstm_gate_update_grad_matches_analytic(recurrent_activation):
    rows, F = 100, 8
    gates = 2.0 * jax.random.normal(jax.random.PRNGKey(0), (rows, 4 * F))
    c = jax.random.normal(jax.random.PRNGKey(1), (rows, F))
    dc_out = jax.random.normal(jax.random.PRNGKey(2), (rows, F))
    dh = jax.random.normal(jax.random.PRNGKey(3), (rows, F))

    _, vjp = jax.vjp(
        lambda g, cc: lstm_gate_update_xla(g, cc, recurrent_activation),
        gates, c)
    dgates, dc = vjp((dc_out, dh))
    ref_g, ref_c = _gate_update_vjp_reference(
        *(np.asarray(a, np.float64) for a in (gates, c, dc_out, dh)),
        recurrent_activation)
    np.testing.assert_allclose(np.asarray(dgates), ref_g, atol=1e-5)
    np.testing.assert_allclose(np.asarray(dc), ref_c, atol=1e-5)


# ---------------------------------------------------------------- preprocess


def test_percentile_normalize_matches_numpy(rng):
    img = rng.integers(0, 60000, (33, 47)).astype(np.uint16)
    a = np.asarray(percentile_normalize(jnp.asarray(img)))
    b = percentile_normalize_np(img)
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_instance_to_three_class():
    lab = np.zeros((10, 10), np.uint16)
    lab[2:5, 2:5] = 1
    lab[5:8, 5:8] = 2
    out = instance_to_three_class(lab)
    assert out[3, 3] == 1          # interior of cell 1
    assert out[2, 2] == 2          # corner → boundary
    assert out[0, 0] == 0          # background
    assert out[5, 5] == 2          # touching cell 1's corner diagonally
    # jax twin agrees
    out_j = np.asarray(instance_to_three_class_jax(jnp.asarray(lab)))
    np.testing.assert_array_equal(out, out_j)


# ---------------------------------------------------------------- CCL


def test_ccl_matches_scipy(rng):
    mask = rng.random((48, 64)) > 0.7
    ours_raw = np.asarray(connected_components(jnp.asarray(mask)))
    ours, n_ours = relabel_compact(jnp.asarray(ours_raw))
    ours = np.asarray(ours)
    ref, n_ref = ndi.label(mask, structure=np.ones((3, 3)))
    assert int(n_ours) == n_ref
    # same partition: bijection between label sets
    for lab in range(1, n_ref + 1):
        vals = np.unique(ours[ref == lab])
        assert len(vals) == 1 and vals[0] > 0
    assert np.all((ours > 0) == mask)


def test_relabel_compact_min_size():
    lab = np.zeros((8, 8), np.int32)
    lab[0:1, 0:2] = 5   # size 2
    lab[4:8, 4:8] = 9   # size 16
    out, n = relabel_compact(jnp.asarray(lab), min_size=4)
    assert int(n) == 1
    assert np.all(np.asarray(out)[4:8, 4:8] == 1)
    assert np.all(np.asarray(out)[0:1, 0:2] == 0)


# ---------------------------------------------------------------- postprocess


def test_postprocess_frame_end_to_end():
    h = w = 32
    probs = np.zeros((h, w, 3), np.float32)
    probs[..., 0] = 1.0
    # cell A: interior block + boundary ring
    probs[4:10, 4:10, 1] = 1.0
    probs[3:11, 3:11, 2] = np.where(probs[3:11, 3:11, 1] == 0, 1.0, 0.0)
    # tiny speck below min size
    probs[20, 20, 1] = 1.0
    probs[..., 0] = 1.0 - probs[..., 1] - probs[..., 2]
    lab = np.asarray(postprocess_frame(
        jnp.asarray(probs), cell_thresh=0.5, edge_thresh=0.3,
        min_cell_size=5, grow_iters=2))
    assert lab.max() == 1                 # speck dropped, one instance
    assert np.all(lab[4:10, 4:10] == 1)   # interior labeled
    assert lab[3, 3] == 1                 # boundary grew into the ring
    assert lab[20, 20] == 0


def _two_cells_shared_band():
    """Cells A (cols 0-2) and B (cols 12-14) sharing a 9-px boundary band."""
    h, w = 8, 15
    probs = np.zeros((h, w, 3), np.float32)
    probs[:, 0:3, 1] = 1.0    # cell A interior
    probs[:, 12:15, 1] = 1.0  # cell B interior
    probs[:, 3:12, 2] = 1.0   # thick shared band
    probs[..., 0] = 1.0 - probs[..., 1] - probs[..., 2]
    return probs


def test_marker_growth_shared_band_nearest_marker():
    """Marker growth exhausts a thick shared band, assigning each pixel to
    the geodesically nearest marker; the equidistant column tie-breaks to
    the raster-first label (VERDICT r1 task 4)."""
    probs = _two_cells_shared_band()
    lab = np.asarray(postprocess_frame(jnp.asarray(probs), min_cell_size=4))
    assert lab.max() == 2
    assert np.all(lab[:, 3:12] > 0)   # band fully labeled (exhaustion)
    # col c: dist(A) = c-2, dist(B) = 12-c → equal at c=7, tie → label 1
    assert np.all(lab[:, 3:8] == 1)
    assert np.all(lab[:, 8:12] == 2)


def test_marker_growth_iter_cap():
    probs = _two_cells_shared_band()
    lab = np.asarray(postprocess_frame(
        jnp.asarray(probs), min_cell_size=4, grow_iters=2))
    assert np.all(lab[:, 3:5] == 1) and np.all(lab[:, 10:12] == 2)
    assert np.all(lab[:, 5:10] == 0)  # beyond the 2-round radius


def test_dilate_mode_leaves_band_center_unlabeled():
    """Legacy fixed-round dilation: 3 rounds leave the center of a 9-px
    band unlabeled — the round-1 behavior the marker mode replaces."""
    probs = _two_cells_shared_band()
    lab = np.asarray(postprocess_frame(
        jnp.asarray(probs), min_cell_size=4, boundary_growth="dilate"))
    assert np.all(lab[:, 3:6] == 1) and np.all(lab[:, 9:12] == 2)
    assert np.all(lab[:, 6:9] == 0)


def test_postprocess_fov_rule():
    """Instances entirely inside the FOV border band are dropped; instances
    touching the interior survive (Inference2D FOV handling [M])."""
    h = w = 32
    probs = np.zeros((h, w, 3), np.float32)
    probs[2:5, 2:5, 1] = 1.0      # fully inside a 6-px border band
    probs[10:20, 10:20, 1] = 1.0  # interior instance
    probs[..., 0] = 1.0 - probs[..., 1]
    lab_no_fov = np.asarray(postprocess_frame(
        jnp.asarray(probs), min_cell_size=2, grow_iters=0, fov=0))
    assert lab_no_fov.max() == 2
    lab_fov = np.asarray(postprocess_frame(
        jnp.asarray(probs), min_cell_size=2, grow_iters=0, fov=6))
    assert lab_fov.max() == 1
    assert lab_fov[3, 3] == 0
    assert lab_fov[15, 15] == 1


def _spiral_mask(n: int) -> np.ndarray:
    """A genuinely CONNECTED 1-px spiral path: geodesic diameter ~n^2/4,
    far beyond any O(n) iteration bound."""
    mask = np.zeros((n, n), bool)
    y = x = 0
    dy, dx = 0, 1
    top, bottom, left, right = 0, n - 1, 0, n - 1
    mask[y, x] = True
    while True:
        ny, nx = y + dy, x + dx
        if dy == 0 and dx == 1 and nx > right:
            dy, dx = 1, 0; top += 2
        elif dy == 1 and dx == 0 and ny > bottom:
            dy, dx = 0, -1; right -= 2
        elif dy == 0 and dx == -1 and nx < left:
            dy, dx = -1, 0; bottom -= 2
        elif dy == -1 and dx == 0 and ny < top:
            dy, dx = 0, 1; left += 2
        ny, nx = y + dy, x + dx
        if not (top - 2 <= ny <= bottom + 2 and left - 2 <= nx <= right + 2):
            break
        if top > bottom or left > right:
            break
        y, x = ny, nx
        mask[y, x] = True
    return mask


def test_ccl_scan_matches_sweep(rng):
    """connected_components_scan (segmented min-scan run propagation) is
    bit-identical to the neighbor-sweep CCL across densities, odd shapes
    and the spiral worst case."""
    from lstm_unet_tpu.ops.ccl import connected_components_scan

    for shape, p in (((48, 64), 0.3), ((64, 64), 0.55), ((33, 47), 0.7)):
        mask = rng.random(shape) < p
        np.testing.assert_array_equal(
            np.asarray(connected_components_scan(jnp.asarray(mask))),
            np.asarray(connected_components(jnp.asarray(mask))))
    spiral = _spiral_mask(24)
    np.testing.assert_array_equal(
        np.asarray(connected_components_scan(jnp.asarray(spiral))),
        np.asarray(connected_components(jnp.asarray(spiral))))


def test_ccl_spiral_worst_case():
    """Long-geodesic SINGLE component (a connected spiral walk): the XLA CCL
    must agree with scipy — guards the iteration bound (an h+w bound
    silently fragmented this case into dozens of instances)."""
    mask = _spiral_mask(24)
    ref, n_ref = ndi.label(mask, structure=np.ones((3, 3)))
    assert n_ref == 1, "test precondition: spiral must be one component"
    ours, n_ours = relabel_compact(connected_components(jnp.asarray(mask)))
    assert int(n_ours) == 1
    np.testing.assert_array_equal(np.asarray(ours), ref)


def test_relabel_auto_resolves_per_platform():
    """'auto' is the measured choice per platform (scatter on the H100 and
    the CPU); explicit methods pass through; unmeasured platforms raise."""
    from lstm_unet_tpu.ops.postprocess import resolve_relabel_method

    assert resolve_relabel_method("auto", "gpu") == "scatter"
    assert resolve_relabel_method("auto", "cpu") == "scatter"
    assert resolve_relabel_method("auto") == "scatter"  # the CPU here
    assert resolve_relabel_method("matmul", "gpu") == "matmul"
    with pytest.raises(ValueError, match="no measured choice"):
        resolve_relabel_method("auto", "rocm")


def test_relabel_mm_matches_scatter():
    """The matmul relabel (one-hot histogram + byte-split remap) is
    bit-identical to the scatter/gather version across size filters."""
    import numpy as np

    from lstm_unet_tpu.ops.ccl import (
        connected_components, relabel_compact, relabel_compact_mm)

    rng = np.random.default_rng(7)
    # odd heights (12, 45) exercise the internal row padding — real CTC
    # frames (e.g. 690x628) are not chunk multiples
    for h, w, p in ((16, 16, 0.3), (64, 32, 0.6), (32, 48, 0.45),
                    (12, 16, 0.5), (45, 24, 0.4)):
        raw = connected_components(jnp.asarray(rng.random((h, w)) < p),
                                   connectivity=8)
        for ms, xs in ((0, 0), (3, 0), (2, 20)):
            a, na = relabel_compact(raw, min_size=ms, max_size=xs)
            b, nb = relabel_compact_mm(raw, min_size=ms, max_size=xs)
            assert int(na) == int(nb)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_relabel_mm_overflow_is_loud():
    """>65535 surviving components exceed the byte-split id range (and the
    uint16 output contract): the count stays exact and the label map is
    poisoned to int32 max so a downstream uint16 cast guard trips."""
    from lstm_unet_tpu.ops.ccl import relabel_compact_mm

    h, w = 256, 320  # 81920 single-pixel components
    labels = (np.arange(h * w, dtype=np.int32) + 1).reshape(h, w)
    out, n = relabel_compact_mm(jnp.asarray(labels))
    assert int(n) == h * w
    assert int(jnp.min(out)) == np.iinfo(np.int32).max


def test_mm_histogram_u16_exact(rng):
    from lstm_unet_tpu.ops.ccl import mm_histogram_u16

    for shape, hi in (((64, 64), 60000), ((30, 29), 65535), ((101, 37), 255)):
        x = rng.integers(0, hi, shape).astype(np.uint16)
        counts = np.asarray(mm_histogram_u16(jnp.asarray(x))).reshape(-1)
        np.testing.assert_array_equal(
            counts, np.bincount(x.reshape(-1), minlength=65536))


def test_integer_percentile_bounds_match_sort():
    """Histogram quantile == sort-based jnp.percentile on the integer
    domain: order statistics agree EXACTLY (test_mm_histogram_u16_exact +
    searchsorted); the final f32 lerp may differ by a few ulp across
    separately-compiled programs (XLA fusion/FMA choices vary with the
    surrounding program — observed 1.5 ulp in-suite vs bit-equal solo).
    The data come from a generator of their own, so they do not depend on
    which tests ran before this one in the same worker."""
    from lstm_unet_tpu.io.preprocess import integer_percentile_bounds

    rng = np.random.default_rng(0)
    for shape, hi in (((64, 64), 60000), ((30, 29), 65535), ((128, 64), 255)):
        x = rng.integers(0, hi, shape).astype(np.uint16)
        lo_h, hi_h = integer_percentile_bounds(jnp.asarray(x))
        ref = jnp.percentile(jnp.asarray(x).astype(jnp.float32).reshape(-1),
                             jnp.array([1.0, 99.0]))
        for a, b in ((lo_h, ref[0]), (hi_h, ref[1])):
            a, b = float(a), float(b)
            assert abs(a - b) <= 4 * np.spacing(np.float32(max(abs(a), abs(b)))), (a, b)


def test_engine_uint16_and_float_paths_agree(rng, tmp_path):
    """The engine's integer (histogram-quantile, raw upload) and float
    (sort-quantile) normalize paths produce the same masks on the same
    frames — the dtype dispatch is a perf choice, not a semantic one."""
    from lstm_unet_tpu.config import CTCInferenceParams, tiny_net_kernel_params as tkp
    from lstm_unet_tpu.engine.infer import StreamingInferenceEngine
    from lstm_unet_tpu.models import ModelConfig, ULSTMnet2D
    from lstm_unet_tpu.io.synthetic import make_cell_sequence

    cfg = ModelConfig.make(tkp())
    params = ULSTMnet2D.init(jax.random.PRNGKey(0), cfg)
    imgs, _ = make_cell_sequence(num_frames=3, height=32, width=32,
                                 num_cells=3, seed=4)
    ip = CTCInferenceParams(min_cell_size=3)
    outs = {}
    for tag, cast in (("u16", lambda f: f), ("f32",
                                             lambda f: f.astype(np.float32))):
        eng = StreamingInferenceEngine(params, cfg, ip)
        masks = [eng.process_frame(cast(f))[0] for f in imgs]
        outs[tag] = masks
    for a, b in zip(outs["u16"], outs["f32"]):
        agree = np.mean(a == b)
        assert agree > 0.999, agree
        assert len(np.unique(a)) == len(np.unique(b))


def test_postprocess_fov_matmul_matches_scatter():
    import numpy as np

    from lstm_unet_tpu.ops.postprocess import postprocess_frame

    rng = np.random.default_rng(3)
    interior = (rng.random((64, 64)) < 0.4).astype(np.float32)
    probs = np.stack([1 - interior, interior, np.zeros_like(interior)], -1)
    for fov in (0, 5, 16):
        a = postprocess_frame(jnp.asarray(probs), min_cell_size=3, fov=fov,
                              relabel_method="scatter")
        b = postprocess_frame(jnp.asarray(probs), min_cell_size=3, fov=fov,
                              relabel_method="matmul")
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_conv_dots_lowering_matches_conv_fwd_and_grad(monkeypatch):
    """Float 'dots' (shifted-tap dot_general) ≈ XLA conv, fwd + backward.

    Unlike the int8 twin (bit-exact integers, test_quant.py) the float
    lowering differs only in the explicit kh·kw add tree over f32 tap
    accumulators vs the conv's single f32 accumulation — tolerances are
    float-roundoff-level. The gradient check matters most: 'dots' exists to
    replace conv-transpose layout copies in BPTT with plain matmul grads.
    """
    import numpy as np

    from lstm_unet_tpu.ops import conv as conv_mod
    from lstm_unet_tpu.ops.conv import conv2d, init_conv

    rng = np.random.default_rng(7)
    for kh, (h, w), ci, co in ((3, (12, 10), 8, 16), (5, (9, 9), 4, 8)):
        x = jnp.asarray(rng.normal(0, 1, (2, h, w, ci)).astype(np.float32))
        c = init_conv(jax.random.PRNGKey(1), kh, kh, ci, co)

        def run(method):
            monkeypatch.setattr(conv_mod, "CONV_METHOD", method)
            monkeypatch.setattr(conv_mod, "CONV_DOTS_MIN_HW", 1)
            y, (gx, gk) = jax.value_and_grad(
                lambda xx, kk: jnp.sum(conv2d(xx, kk, c["bias"]) ** 2),
                argnums=(0, 1))(x, c["kernel"])
            return y, gx, gk

        y_c, gx_c, gk_c = run("conv")
        y_d, gx_d, gk_d = run("dots")
        np.testing.assert_allclose(y_d, y_c, rtol=2e-5)
        np.testing.assert_allclose(gx_d, gx_c, rtol=2e-4, atol=1e-4)
        np.testing.assert_allclose(gk_d, gk_c, rtol=2e-4, atol=1e-4)

    # gate: strides / even kernels / small HW always take the conv path
    monkeypatch.setattr(conv_mod, "CONV_METHOD", "dots")
    monkeypatch.setattr(conv_mod, "CONV_DOTS_MIN_HW", 10 ** 9)
    x = jnp.ones((1, 8, 8, 4))
    c = init_conv(jax.random.PRNGKey(2), 3, 3, 4, 4)
    out = conv2d(x, c["kernel"], c["bias"], stride=(2, 2))
    assert out.shape == (1, 4, 4, 4)


def test_size_filter_post_keeps_grown_crescent():
    """size_filter='post' measures min_cell_size on the GROWN extent: an
    occlusion crescent whose visible interior is tiny (below the bar) still
    seeds growth and survives if interior+band clears the bar; the default
    'pre' (reference order [M]) drops it before growth. A second instance
    comfortably above the bar is identical under both orders."""
    h = w = 32
    probs = np.zeros((h, w, 3), np.float32)
    # cell A: 8x8 interior (64 px > min 20), thin ring band
    probs[2:10, 2:10, 1] = 1.0
    probs[1:11, 1:11, 2] = np.where(probs[1:11, 1:11, 1] == 0, 1.0, 0.0)
    # crescent B: 3x3 interior (9 px < min 20) + a 7x7 band around it
    # (grown extent 9 + ring = 49 px higher than the bar)
    probs[20:23, 20:23, 1] = 1.0
    probs[18:25, 18:25, 2] = np.where(probs[18:25, 18:25, 1] == 0, 1.0, 0.0)
    probs[..., 0] = 1.0 - probs[..., 1] - probs[..., 2]

    pre = np.asarray(postprocess_frame(
        jnp.asarray(probs), cell_thresh=0.5, edge_thresh=0.3,
        min_cell_size=20, size_filter="pre"))
    post = np.asarray(postprocess_frame(
        jnp.asarray(probs), cell_thresh=0.5, edge_thresh=0.3,
        min_cell_size=20, size_filter="post"))

    assert pre.max() == 1                     # crescent dropped pre-growth
    assert np.all(pre[18:25, 18:25] == 0)
    assert post.max() == 2                    # crescent survives post
    assert post[21, 21] != 0
    assert (post == post[21, 21]).sum() == 49  # interior + grown ring
    # cell A identical under both orders
    a_pre, a_post = pre[5, 5], post[5, 5]
    np.testing.assert_array_equal(pre == a_pre, post == a_post)


def test_size_filter_post_equals_pre_when_no_small_components():
    """With every interior above the bar, 'post' only ADDS the grown band
    to the measured size — outputs must be bit-identical to 'pre'."""
    h = w = 32
    probs = np.zeros((h, w, 3), np.float32)
    probs[4:12, 4:12, 1] = 1.0
    probs[3:13, 3:13, 2] = np.where(probs[3:13, 3:13, 1] == 0, 1.0, 0.0)
    probs[20:26, 18:26, 1] = 1.0
    probs[..., 0] = 1.0 - probs[..., 1] - probs[..., 2]
    kw = dict(cell_thresh=0.5, edge_thresh=0.3, min_cell_size=10)
    pre = np.asarray(postprocess_frame(jnp.asarray(probs),
                                       size_filter="pre", **kw))
    post = np.asarray(postprocess_frame(jnp.asarray(probs),
                                        size_filter="post", **kw))
    np.testing.assert_array_equal(pre, post)


def test_size_filter_post_max_size_drops_overgrown():
    """'post' applies max_cell_size to the grown extent too: an instance
    whose interior passes 'pre' but whose grown extent exceeds the cap is
    dropped under 'post'."""
    h = w = 32
    probs = np.zeros((h, w, 3), np.float32)
    probs[8:16, 8:16, 1] = 1.0                  # 64-px interior
    probs[4:20, 4:20, 2] = np.where(probs[4:20, 4:20, 1] == 0, 1.0, 0.0)
    probs[..., 0] = 1.0 - probs[..., 1] - probs[..., 2]
    kw = dict(cell_thresh=0.5, edge_thresh=0.3, min_cell_size=10,
              max_cell_size=100)
    pre = np.asarray(postprocess_frame(jnp.asarray(probs),
                                       size_filter="pre", **kw))
    post = np.asarray(postprocess_frame(jnp.asarray(probs),
                                        size_filter="post", **kw))
    assert pre.max() == 1      # 64 <= 100 pre-growth
    assert post.max() == 0     # 16*16=256 > 100 grown
