"""2D conv / pool / upsample primitives, NHWC.

Reference parity: the reference delegates these to Keras/cuDNN
(SURVEY.md §2 — "all heavy lifting is delegated to stock TF/Keras kernels");
here XLA's `conv_general_dilated` (cuDNN on the GPU) with elementwise
activations left for XLA to fuse. SAME padding geometry
matches TF (SURVEY.md §7 hard-part #4).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

_DIMNUMS = ("NHWC", "HWIO", "NHWC")

# float conv lowering method, mirroring ops/quant.py's int8 knob: 'conv' =
# conv_general_dilated; 'dots' = shifted-tap accumulation, a kh×kw
# SAME/stride-1 conv as the sum of kh·kw channel matmuls over statically
# shifted views — plain dot_general, no conv-specific layouts, and its
# backward is also plain matmuls. f32 tap accumulation, one final round to
# the input dtype, so results are close-not-bit-identical to 'conv' in
# float (unlike the int8 twin, which is exact). 'auto' resolves to 'conv'
# (ROADMAP D2 decides the knob on the card).
CONV_METHOD = os.environ.get("LSTM_UNET_CONV", "conv")
CONV_DOTS_MIN_HW = 128 * 128


def _resolve_method(method: str) -> str:
    if method == "auto":
        return "conv"
    return method


def set_conv_method(method: str) -> None:
    """Process-wide conv lowering selection (config knob -> module flags).

    Sets BOTH the float flag here and the int8 twin's flag (bit-identical
    lowering pair) so one `conv_method` config field governs the run.
    """
    if method not in ("conv", "dots", "auto"):
        raise ValueError(f"unknown conv_method {method!r}")
    global CONV_METHOD
    CONV_METHOD = method
    from . import quant

    quant.INT8_CONV_METHOD = method


def dots_accumulate(x: jax.Array, kernel: jax.Array, acc_dtype) -> jax.Array:
    """SAME/stride-1 NHWC conv as kh·kw shifted-tap dot_generals.

    Shared core of the float ('dots') and int8 (`ops/quant.py::_conv_int8`)
    lowerings; only the accumulator element type differs (f32 vs int32).
    Contracts ci directly on the 4-D tap — XLA collapses the free dims
    itself, no reshape op to place.
    """
    n, h, w, ci = x.shape
    kh, kw, _, co = kernel.shape
    ph, pw = kh // 2, kw // 2
    xp = jnp.pad(x, ((0, 0), (ph, ph), (pw, pw), (0, 0)))
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            tap = jax.lax.slice(xp, (0, dy, dx, 0), (n, dy + h, dx + w, ci))
            t = jax.lax.dot_general(
                tap, kernel[dy, dx], (((3,), (0,)), ((), ())),
                preferred_element_type=acc_dtype)
            acc = t if acc is None else acc + t
    return acc


def _conv_dots(x: jax.Array, kernel: jax.Array) -> jax.Array:
    """f32 tap accumulation, one final round to the input dtype."""
    return dots_accumulate(x, kernel, jnp.float32).astype(x.dtype)


def init_conv(rng: jax.Array, kh: int, kw: int, cin: int, cout: int,
              dtype=jnp.float32) -> dict:
    """Glorot-uniform conv kernel + zero bias (Keras Conv2D default init)."""
    fan_in, fan_out = kh * kw * cin, kh * kw * cout
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    kernel = jax.random.uniform(rng, (kh, kw, cin, cout), dtype, -limit, limit)
    return {"kernel": kernel, "bias": jnp.zeros((cout,), dtype)}


def conv2d(x: jax.Array, kernel: jax.Array, bias: Optional[jax.Array] = None,
           stride: Tuple[int, int] = (1, 1), padding: str = "SAME") -> jax.Array:
    """NHWC conv in the input dtype.

    bf16 products accumulate in f32 inside the conv, so bf16 in/out keeps
    f32 accumulation without forcing an f32 output. (Forcing
    ``preferred_element_type=f32`` also breaks the bf16 backward pass: the
    conv transpose then pairs an f32 cotangent with bf16 operands.)
    """
    kh, kw = kernel.shape[0], kernel.shape[1]
    if (_resolve_method(CONV_METHOD) == "dots"
            and stride == (1, 1) and padding == "SAME"
            and kh % 2 == 1 and kw % 2 == 1
            and x.shape[1] * x.shape[2] >= CONV_DOTS_MIN_HW):
        y = _conv_dots(x, kernel.astype(x.dtype))
    else:
        y = jax.lax.conv_general_dilated(
            x, kernel.astype(x.dtype), stride, padding,
            dimension_numbers=_DIMNUMS,
        )
    if bias is not None:
        y = y + bias.astype(y.dtype)
    return y


def activate(x: jax.Array, kind: str) -> jax.Array:
    if kind == "leaky_relu":
        return jax.nn.leaky_relu(x, negative_slope=0.2)
    if kind == "relu":
        return jax.nn.relu(x)
    if kind == "tanh":
        return jnp.tanh(x)
    if kind in ("none", "linear"):
        return x
    raise ValueError(f"unknown activation {kind!r}")


def max_pool_2x2(x: jax.Array) -> jax.Array:
    """2x2/stride-2 max pool (reference: Keras MaxPool2D between levels [H])."""
    return jax.lax.reduce_window(
        x, -jnp.inf if jnp.issubdtype(x.dtype, jnp.floating) else jnp.iinfo(x.dtype).min,
        jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID",
    )


def upsample_2x(x: jax.Array, method: str = "nearest") -> jax.Array:
    """2x spatial upsample (reference: Keras UpSampling2D, nearest [M])."""
    b, h, w, c = x.shape
    if method == "nearest":
        # einops-style repeat compiles to a cheap broadcast+reshape
        return jnp.broadcast_to(x[:, :, None, :, None, :], (b, h, 2, w, 2, c)).reshape(
            b, 2 * h, 2 * w, c)
    if method == "bilinear":
        return jax.image.resize(x, (b, 2 * h, 2 * w, c), "bilinear").astype(x.dtype)
    raise ValueError(f"unknown upsample method {method!r}")
