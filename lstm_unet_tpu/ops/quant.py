"""int8 quantized inference (no reference analog).

Tensor cores run int8 at twice their bf16 rate, and int8 activations halve
the bytes into each conv, so int8 convs can cut both the compute and the
bandwidth term of the streaming step. Whether they do on a given device is
a measurement (PERF.md), not an assumption.

Scheme (symmetric, zero-point 0 — SAME zero-padding stays exact):
- weights: per-output-channel scales, ``q = round(k / s_w)`` in [-127, 127]
- activations: dynamic per-tensor scale ``s_x = max|x| / 127`` computed on
  the fly (a cheap fused reduction; no calibration pass or stored stats)
- conv: int8 x int8 -> int32 accumulation
  (``preferred_element_type=int32``), dequantized in f32 in the epilogue:
  ``y = acc * (s_x * s_w) + bias``

Gate math / LayerNorm / softmax stay in f32 exactly as the bf16 path; only
the convs and their activation operands change width. Quantized
param dicts are self-describing: the presence of ``kernel_q`` (convs) or
``kernel_x_q`` (ConvLSTM cells) selects the int8 path in the model.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

_DIMNUMS = ("NHWC", "HWIO", "NHWC")


def quantize_weight(kernel: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """[kh,kw,cin,cout] float -> (int8 kernel, per-cout f32 scale)."""
    k = kernel.astype(jnp.float32)
    s = jnp.max(jnp.abs(k), axis=(0, 1, 2)) / 127.0
    s = jnp.maximum(s, 1e-12)
    q = jnp.clip(jnp.round(k / s), -127, 127).astype(jnp.int8)
    return q, s


def quantize_act(x: jax.Array, scale: Optional[jax.Array] = None
                 ) -> Tuple[jax.Array, jax.Array]:
    """Per-tensor symmetric quantization -> (int8 x, scalar f32 scale).

    ``scale=None`` computes the scale dynamically (max|x|/127); a provided
    scale (e.g. from calibration) skips the reduction pass.
    """
    xf = x.astype(jnp.float32)
    if scale is None:
        scale = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-8) / 127.0
    q = jnp.clip(jnp.round(xf / scale), -127, 127).astype(jnp.int8)
    return q, scale


# int8 conv accumulator element type: int32 is exact.
ACC_DTYPE = jnp.int32

# int8 conv lowering method. 'conv' = conv_general_dilated. 'dots' =
# shifted-tap accumulation: a kh×kw conv is the exact integer sum of kh·kw
# channel matmuls over statically shifted views, lowering to plain
# dot_general with no conv-specific layout assignment. Bit-identical by
# construction (integer arithmetic, same accumulator). 'dots' applies only
# where h·w ≥ INT8_DOTS_MIN_HW; small levels keep the conv. 'auto' resolves
# to 'conv' (ROADMAP D2 decides the knob on the card).
import os as _os

INT8_CONV_METHOD = _os.environ.get("LSTM_UNET_INT8_CONV", "conv")
INT8_DOTS_MIN_HW = 128 * 128


def _conv_int8(qx: jax.Array, kq: jax.Array) -> jax.Array:
    """int8 NHWC SAME conv -> int32, via the selected lowering method."""
    from .conv import dots_accumulate

    _, h, w, _ = qx.shape
    kh, kw, _, _ = kq.shape
    # 'auto' → 'conv' here — only an explicit 'dots' selects dots.
    if (INT8_CONV_METHOD != "dots"
            or h * w < INT8_DOTS_MIN_HW
            or kh % 2 == 0 or kw % 2 == 0):
        return jax.lax.conv_general_dilated(
            qx, kq, (1, 1), "SAME", dimension_numbers=_DIMNUMS,
            preferred_element_type=ACC_DTYPE)
    # exact integer arithmetic — the shared tap loop with an int32
    # accumulator is bit-identical to the conv lowering above
    return dots_accumulate(qx, kq, ACC_DTYPE)


def conv2d_q(x: jax.Array, qconv: Dict[str, jax.Array],
             out_dtype=jnp.float32) -> jax.Array:
    """NHWC int8 conv with f32 dequant epilogue.

    ``qconv`` holds ``kernel_q`` int8 [kh,kw,cin,cout], ``w_scale`` f32
    [cout], optional ``bias`` f32 [cout], optional static ``x_scale``
    (calibrated input scale — skips the dynamic abs-max pass).
    """
    qx, s_x = quantize_act(x, qconv.get("x_scale"))
    acc = _conv_int8(qx, qconv["kernel_q"])
    y = acc.astype(jnp.float32) * (s_x * qconv["w_scale"])
    bias = qconv.get("bias")
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(out_dtype)


def conv2d_q_pair(a: jax.Array, b: jax.Array, qconv: Dict[str, jax.Array],
                  out_dtype=jnp.float32) -> jax.Array:
    """Quantized ``conv(concat([a, b]), W)`` as two channel-sliced convs.

    Skips the concat materialization/layout copy, and each operand gets its
    OWN per-tensor activation scale (strictly tighter than one shared scale
    over the concat).
    """
    ca = a.shape[-1]
    qa, s_a = quantize_act(a, qconv.get("x_scale_a"))
    qb, s_b = quantize_act(b, qconv.get("x_scale_b"))
    k = qconv["kernel_q"]
    acc_a = _conv_int8(qa, k[:, :, :ca])
    acc_b = _conv_int8(qb, k[:, :, ca:])
    w = qconv["w_scale"]
    y = (acc_a.astype(jnp.float32) * (s_a * w)
         + acc_b.astype(jnp.float32) * (s_b * w))
    bias = qconv.get("bias")
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(out_dtype)


def _scale_of(act_scales: Optional[Dict[str, float]], site: str):
    """Calibrated absmax for a site -> static x_scale (absmax/127), or None."""
    if act_scales is None or site not in act_scales:
        return None
    return jnp.asarray(max(float(act_scales[site]), 1e-8) / 127.0, jnp.float32)


def _quantize_conv_dict(conv: Dict[str, jax.Array],
                        act_scales: Optional[Dict[str, float]] = None,
                        site: str = "") -> Dict[str, jax.Array]:
    q, s = quantize_weight(conv["kernel"])
    out = {"kernel_q": q, "w_scale": s,
           "bias": conv["bias"].astype(jnp.float32)}
    for k in ("ln_scale", "ln_bias"):  # LayerNorm stays f32
        if k in conv:
            out[k] = conv[k]
    for key, suffix in (("x_scale", ""), ("x_scale_a", ".a"),
                        ("x_scale_b", ".b")):
        sc = _scale_of(act_scales, site + suffix)
        if sc is not None:
            out[key] = sc
    return out


def _quantize_lstm_dict(cell: Dict[str, jax.Array],
                        act_scales: Optional[Dict[str, float]] = None,
                        site: str = "") -> Dict[str, jax.Array]:
    qx, sx = quantize_weight(cell["kernel_x"])
    qh, sh = quantize_weight(cell["kernel_h"])
    out = {"kernel_x_q": qx, "wx_scale": sx,
           "kernel_h_q": qh, "wh_scale": sh,
           "bias": cell["bias"].astype(jnp.float32)}
    for key, suffix in (("x_scale", "/x"), ("h_scale", "/h")):
        sc = _scale_of(act_scales, site + suffix)
        if sc is not None:
            out[key] = sc
    return out


def _cast_float_site(node: Dict, dtype) -> Dict:
    """Float conv/cell dict pre-cast to the compute dtype (ln_* stays f32 —
    same rule as models/ulstm_unet.py::cast_params_for_inference)."""
    if dtype is None:
        return node
    return {k: (v if k.startswith("ln_")
                or not (hasattr(v, "dtype")
                        and jnp.issubdtype(v.dtype, jnp.floating))
                else v.astype(dtype))
            for k, v in node.items()}


def parse_keep_float(keep_float) -> tuple:
    """Normalize a keep-float spec to a tuple of site prefixes.

    Accepts the raw comma-separated CLI string ('encoder/0, encoder/1'),
    an iterable of prefixes, or None/'' — every caller (engine.infer,
    bench.py, tests) funnels through here so whitespace/empty-entry
    handling cannot diverge across call sites."""
    if keep_float is None:
        return ()
    if isinstance(keep_float, str):
        keep_float = keep_float.split(",")
    return tuple(s for s in (p.strip() for p in keep_float) if s)


def _site_kept(site: str, keep_float) -> bool:
    """True when ``site`` matches a keep-float prefix ('encoder/0' matches
    encoder/0/... but not encoder/01/...)."""
    for p in keep_float:
        p = p.strip().strip("/")
        if p and (site == p or site.startswith(p + "/")):
            return True
    return False


def quantize_params_int8(params: Dict,
                         act_scales: Optional[Dict[str, float]] = None,
                         keep_float=(), float_dtype=None) -> Dict:
    """ULSTMnet2D param tree (f32/bf16) -> int8 inference tree.

    Mirrors the model structure from models/ulstm_unet.py::ULSTMnet2D.init:
    encoder levels ({lstm: [...], convs: [...]}), decoder levels
    ({convs: [...]}), head.

    ``act_scales``: calibrated per-site activation absmax values keyed by
    the collect_scales site names (models/ulstm_unet.py::ULSTMnet2D.step);
    present sites get static ``x_scale`` entries (the dynamic per-frame
    abs-max reduction pass — one full HBM read of every conv input —
    disappears from the compiled step). Missing sites stay dynamic.

    ``keep_float``: comma-separated string or iterable of site-name
    prefixes (e.g. ``("encoder/0", "head")``; normalized via
    ``parse_keep_float``)
    whose conv/cell dicts stay FLOAT (cast to ``float_dtype``) — the model
    dispatches per site on the presence of ``kernel_q``, so int8 and float
    convs mix freely in one tree (mixed-precision serving).
    """
    keep_float = parse_keep_float(keep_float)

    def conv(c, site):
        return (_cast_float_site(c, float_dtype)
                if _site_kept(site, keep_float)
                else _quantize_conv_dict(c, act_scales, site))

    def cell(c, site):
        return (_cast_float_site(c, float_dtype)
                if _site_kept(site, keep_float)
                else _quantize_lstm_dict(c, act_scales, site))

    return {
        "encoder": [
            {"lstm": [cell(c, f"encoder/{i}/lstm/{j}")
                      for j, c in enumerate(lvl["lstm"])],
             "convs": [conv(c, f"encoder/{i}/convs/{j}")
                       for j, c in enumerate(lvl["convs"])]}
            for i, lvl in enumerate(params["encoder"])
        ],
        "decoder": [
            {"convs": [conv(c, f"decoder/{i}/convs/{j}")
                       for j, c in enumerate(lvl["convs"])]}
            for i, lvl in enumerate(params["decoder"])
        ],
        "head": conv(params["head"], "head"),
    }
