"""int8 quantized inference path (ops/quant.py).

SEG-parity on the flagship model is measured on the card; these tests pin
the numerics and the end-to-end plumbing on CPU.
"""

import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lstm_unet_tpu.config import CTCInferenceParams, CTCParams, tiny_net_kernel_params
from lstm_unet_tpu.models import ModelConfig, ULSTMnet2D
from lstm_unet_tpu.ops.conv import conv2d, init_conv
from lstm_unet_tpu.ops.quant import (
    conv2d_q,
    quantize_params_int8,
    quantize_weight,
)


def test_quantize_weight_roundtrip(rng):
    k = jnp.asarray(rng.normal(0, 0.1, (3, 3, 8, 16)).astype(np.float32))
    q, s = quantize_weight(k)
    assert q.dtype == jnp.int8 and s.shape == (16,)
    deq = q.astype(jnp.float32) * s
    # per-channel max error bounded by half a quantization step
    err = np.abs(np.asarray(deq - k))
    step = np.asarray(s)[None, None, None, :]
    assert np.all(err <= 0.5 * step + 1e-9)


def test_conv2d_q_matches_float_conv(rng):
    x = jnp.asarray(rng.normal(0, 1.0, (2, 16, 16, 8)).astype(np.float32))
    conv = init_conv(jax.random.PRNGKey(0), 3, 3, 8, 16)
    q, s = quantize_weight(conv["kernel"])
    y_ref = np.asarray(conv2d(x, conv["kernel"], conv["bias"]))
    y_q = np.asarray(conv2d_q(
        x, {"kernel_q": q, "w_scale": s, "bias": conv["bias"]}))
    # int8 symmetric quantization: relative error on the order of 1/127
    denom = max(np.abs(y_ref).max(), 1e-6)
    assert np.abs(y_q - y_ref).max() / denom < 0.05


def test_int8_model_step_close_to_f32():
    cfg32 = ModelConfig.make(tiny_net_kernel_params())
    cfg8 = ModelConfig.make(tiny_net_kernel_params(), quant="int8")
    params = ULSTMnet2D.init(jax.random.PRNGKey(1), cfg32)
    qparams = quantize_params_int8(params)
    state = ULSTMnet2D.init_state(cfg32, 1, 16, 16)
    x = jax.random.normal(jax.random.PRNGKey(2), (1, 16, 16, 1))
    _, logits32 = ULSTMnet2D.step(params, state, x, cfg32)
    _, logits8 = ULSTMnet2D.step(qparams, state, x, cfg8)
    denom = max(float(jnp.abs(logits32).max()), 1e-6)
    rel = float(jnp.abs(logits8 - logits32).max()) / denom
    assert rel < 0.15, rel  # random weights, 2 ConvLSTM levels of error accum


@pytest.fixture(scope="module")
def trained_tiny(tmp_path_factory):
    from lstm_unet_tpu.engine.train import Trainer
    from lstm_unet_tpu.io.synthetic import write_ctc_dataset

    root = str(tmp_path_factory.mktemp("ctc"))
    write_ctc_dataset(root, num_frames=8, height=32, width=32, num_cells=3,
                      seed=7)
    p = CTCParams(
        root_data_dir=root,
        train_sequence_list=[("Synth-N2DH-SIM", "01")],
        crop_size=(32, 32), batch_size=2, unroll_len=3,
        net_kernel_params=tiny_net_kernel_params(), learning_rate=3e-3,
        root_save_dir=str(tmp_path_factory.mktemp("runs")),
        print_to_console_interval=50, validation_interval=10**6,
        save_checkpoint_iteration=10**6, write_to_tb_interval=10**6)
    t = Trainer(p, seed=0)
    t.train(num_iterations=80)
    return root, p.experiment_save_dir


def test_int8_inference_end_to_end_seg_parity(trained_tiny, tmp_path):
    """dtype='int8' streams end-to-end; instance masks agree with the f32
    masks at the SEG level (the VERDICT r1 gate, here on the tiny model)."""
    from lstm_unet_tpu.engine.infer import run_inference
    from lstm_unet_tpu.io.tiff import read_tiff
    from lstm_unet_tpu.metrics import seg_measure_sequence

    root, ckpt = trained_tiny
    seq = os.path.join(root, "Synth-N2DH-SIM", "01")
    outs = {}
    for dt in ("float32", "int8"):
        ip = CTCInferenceParams(
            model_path=ckpt, sequence_path=seq,
            output_path=str(tmp_path / dt), min_cell_size=5,
            pre_sequence_frames=1, dtype=dt)
        n = run_inference(ip)
        assert n == 8
        outs[dt] = [read_tiff(p) for p in sorted(
            glob.glob(str(tmp_path / dt / "mask*.tif")))]
    # score int8 masks against f32 masks as pseudo-GT: near-perfect overlap
    score = seg_measure_sequence(outs["float32"], outs["int8"])
    assert score > 0.9, score


def test_collect_scales_covers_every_conv_site():
    cfg = ModelConfig.make(tiny_net_kernel_params())
    params = ULSTMnet2D.init(jax.random.PRNGKey(1), cfg)
    state = ULSTMnet2D.init_state(cfg, 1, 16, 16)
    x = jax.random.normal(jax.random.PRNGKey(2), (1, 16, 16, 1))
    collect = {}
    ULSTMnet2D.step(params, state, x, cfg, collect_scales=collect)
    nkp = cfg.nkp
    n_lstm = sum(len(l) for l in nkp.lstm_kernels)
    n_convs = (sum(len(l) for l in nkp.down_conv_kernels)
               + sum(len(l) for l in nkp.up_conv_kernels))
    # per LSTM: x + h sites; per conv: 1 site; head: 1
    assert len(collect) == 2 * n_lstm + n_convs + 1, sorted(collect)
    # h-sites are 0 on the first frame (zero initial LSTM state); every
    # other site must have seen a real activation
    assert all(float(v) > 0 for k, v in collect.items()
               if not k.endswith("/h"))
    assert all(float(v) >= 0 for v in collect.values())


def test_static_scale_matches_dynamic_when_exact(rng):
    """A static x_scale equal to the dynamic absmax/127 must produce the
    bit-identical conv output (the static path only skips the reduction)."""
    x = jnp.asarray(rng.normal(0, 1.0, (1, 8, 8, 8)).astype(np.float32))
    conv = init_conv(jax.random.PRNGKey(0), 3, 3, 8, 16)
    q, s = quantize_weight(conv["kernel"])
    qdict = {"kernel_q": q, "w_scale": s, "bias": conv["bias"]}
    y_dyn = np.asarray(conv2d_q(x, qdict))
    x_scale = jnp.max(jnp.abs(x)) / 127.0
    y_static = np.asarray(conv2d_q(x, {**qdict, "x_scale": x_scale}))
    np.testing.assert_array_equal(y_dyn, y_static)


def test_act_scales_provenance_guard(tmp_path):
    """Stale act_scales.json (checkpoint advanced or arch changed since
    calibration) must be rejected -> dynamic-scale fallback (VERDICT r2
    weak #6); unstamped legacy files still load with a warning."""
    import json

    from lstm_unet_tpu.engine.infer import load_act_scales, save_act_scales

    d = str(tmp_path / "model")
    os.makedirs(os.path.join(d, "100"))  # checkpoint step dir
    with open(os.path.join(d, "model_params.json"), "w") as f:
        json.dump({"model_config": {"dtype": "float32"}}, f)

    save_act_scales(d, {"head": 1.5})
    assert load_act_scales(d) == {"head": 1.5}

    # checkpoint advances after calibration -> stale -> None (dynamic)
    os.makedirs(os.path.join(d, "200"))
    assert load_act_scales(d) is None
    os.rmdir(os.path.join(d, "200"))
    assert load_act_scales(d) == {"head": 1.5}

    # architecture file rewritten -> stale -> None
    with open(os.path.join(d, "model_params.json"), "w") as f:
        json.dump({"model_config": {"dtype": "bfloat16"}}, f)
    assert load_act_scales(d) is None

    # legacy file without a provenance stamp: accepted (warn-only)
    with open(os.path.join(d, "act_scales.json"), "w") as f:
        json.dump({"head": 2.0}, f)
    assert load_act_scales(d) == {"head": 2.0}

    # step-selected runs (ckpt_step plumbing): scales calibrated at an
    # explicit step only match runs restoring that same step
    with open(os.path.join(d, "model_params.json"), "w") as f:
        json.dump({"model_config": {"dtype": "float32"}}, f)
    os.makedirs(os.path.join(d, "200"))
    save_act_scales(d, {"head": 3.0}, step=100)
    assert load_act_scales(d, step=100) == {"head": 3.0}
    assert load_act_scales(d, step=200) is None   # different weights
    assert load_act_scales(d) is None             # latest (200) != 100
    save_act_scales(d, {"head": 4.0})             # latest = 200
    assert load_act_scales(d) == {"head": 4.0}
    assert load_act_scales(d, step=200) == {"head": 4.0}
    assert load_act_scales(d, step=100) is None


def test_calibrated_int8_end_to_end(trained_tiny, tmp_path):
    """calibrate_model_dir writes act_scales.json; the int8 engine picks it
    up and the masks still SEG-match the dynamic-scale int8 masks."""
    from lstm_unet_tpu.engine.infer import (
        calibrate_model_dir, load_act_scales, run_inference)
    from lstm_unet_tpu.io.tiff import read_tiff
    from lstm_unet_tpu.metrics import seg_measure_sequence
    from lstm_unet_tpu.ops.quant import quantize_params_int8

    root, ckpt = trained_tiny
    seq = os.path.join(root, "Synth-N2DH-SIM", "01")
    path = calibrate_model_dir(ckpt, seq, n_frames=4)
    scales = load_act_scales(ckpt)
    assert scales and os.path.exists(path)
    # quantized tree gains static-scale leaves at the calibrated sites
    cfg = ModelConfig.make(tiny_net_kernel_params())
    params = ULSTMnet2D.init(jax.random.PRNGKey(1), cfg)
    qp = quantize_params_int8(params, scales)
    assert "x_scale" in qp["head"] and "x_scale" in qp["encoder"][0]["lstm"][0]
    assert "h_scale" in qp["encoder"][0]["lstm"][0]

    outs = {}
    for tag in ("dynamic", "calibrated"):
        if tag == "dynamic":
            os.rename(path, path + ".bak")  # hide scales -> dynamic path
        ip = CTCInferenceParams(
            model_path=ckpt, sequence_path=seq,
            output_path=str(tmp_path / tag), min_cell_size=5,
            pre_sequence_frames=1, dtype="int8")
        run_inference(ip)
        if tag == "dynamic":
            os.rename(path + ".bak", path)
        outs[tag] = [read_tiff(p) for p in sorted(
            glob.glob(str(tmp_path / tag / "mask*.tif")))]
    score = seg_measure_sequence(outs["dynamic"], outs["calibrated"])
    assert score > 0.9, score


def test_int8_dots_lowering_bit_identical(rng, monkeypatch):
    """'dots' (shifted-tap dot_general) == 'conv' lowering, bit-exact.

    Integer arithmetic with the same int32 accumulator: the sum of kh*kw
    channel matmuls over statically shifted views is EXACTLY the SAME-padded
    conv — any difference is a lowering bug, not tolerance.
    """
    from lstm_unet_tpu.ops import quant

    # third case: non-square H/W (real-CTC 690x628-style geometry scaled down)
    for kh, (h, w), ci, co in ((3, (16, 16), 8, 16), (5, (12, 12), 6, 8),
                               (3, (18, 14), 4, 8)):
        x = jnp.asarray(rng.normal(0, 1.0, (2, h, w, ci)).astype(np.float32))
        conv = init_conv(jax.random.PRNGKey(3), kh, kh, ci, co)
        q, s = quantize_weight(conv["kernel"])
        qconv = {"kernel_q": q, "w_scale": s, "bias": conv["bias"]}
        monkeypatch.setattr(quant, "INT8_CONV_METHOD", "conv")
        y_conv = np.asarray(conv2d_q(x, qconv))
        monkeypatch.setattr(quant, "INT8_CONV_METHOD", "dots")
        monkeypatch.setattr(quant, "INT8_DOTS_MIN_HW", 1)
        y_dots = np.asarray(conv2d_q(x, qconv))
        np.testing.assert_array_equal(y_conv, y_dots)


def test_keep_float_mixed_tree():
    """keep_float prefixes stay float (per-site dispatch on kernel_q), the
    rest quantize; the mixed step runs and sits between f32 and full-int8
    in accuracy ordering is NOT asserted (not guaranteed pointwise) — only
    closeness to f32 and structural correctness are."""
    cfg32 = ModelConfig.make(tiny_net_kernel_params())
    cfg8 = ModelConfig.make(tiny_net_kernel_params(), quant="int8")
    params = ULSTMnet2D.init(jax.random.PRNGKey(1), cfg32)
    mixed = quantize_params_int8(
        params, keep_float=("encoder/0", "head"),
        float_dtype=jnp.bfloat16)
    # structure: encoder level 0 + head stay float, everything else int8
    assert "kernel_x" in mixed["encoder"][0]["lstm"][0]
    assert "kernel" in mixed["encoder"][0]["convs"][0]
    assert mixed["encoder"][0]["convs"][0]["kernel"].dtype == jnp.bfloat16
    assert "kernel" in mixed["head"] and "kernel_q" not in mixed["head"]
    assert "kernel_x_q" in mixed["encoder"][1]["lstm"][0]
    assert "kernel_q" in mixed["decoder"][0]["convs"][0]
    # prefix matching is path-segment aware: 'encoder/0' must not keep a
    # hypothetical 'encoder/01...' (guard the startswith boundary)
    from lstm_unet_tpu.ops.quant import _site_kept
    assert _site_kept("encoder/0/convs/1", ("encoder/0",))
    assert not _site_kept("encoder/01/convs/1", ("encoder/0",))
    # the mixed tree runs through the int8-config step and stays close to f32
    state = ULSTMnet2D.init_state(cfg32, 1, 16, 16)
    x = jax.random.normal(jax.random.PRNGKey(2), (1, 16, 16, 1))
    _, logits32 = ULSTMnet2D.step(params, state, x, cfg32)
    _, logits_mixed = ULSTMnet2D.step(mixed, state, x, cfg8)
    denom = max(float(jnp.abs(logits32).max()), 1e-6)
    rel = float(jnp.abs(logits_mixed - logits32).max()) / denom
    assert rel < 0.15, rel
    # keep_float=() with float_dtype stays a pure-int8 tree (no regression)
    full = quantize_params_int8(params, keep_float=(),
                                float_dtype=jnp.bfloat16)
    assert "kernel_q" in full["head"]
