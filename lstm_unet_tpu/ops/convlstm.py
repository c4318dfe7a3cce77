"""ConvLSTM2D cell.

Reference parity: Keras ``ConvLSTM2D`` as used per encoder level in
``Networks.py::DownBlock2D`` (SURVEY.md §2, §3.3). Semantics reproduced:

- gate pre-activations = conv(x, Wx) + conv(h, Wh) + b over 4F channels —
  the same separate input/recurrent kernels Keras uses (two convs also skip
  materializing a concat([x, h]) buffer),
- gate order (i, f, candidate, o), unit forget-gate bias init,
- recurrent_activation 'sigmoid' (or 'hard_sigmoid' for Keras-2.0 parity),
- explicit (h, c) carry as a pytree — the reference manages Keras layer
  state via reset_states_per_batch/get_states/set_states (SURVEY.md §2
  "Full model"); here state is a value, which makes truncated BPTT,
  per-lane reset, donation, and sharding trivial.

The post-conv gate math (:func:`lstm_gate_update_xla`) is plain
``jax.numpy`` that XLA fuses into one elementwise pass over the gate tensor.

Init deviation (documented): Keras uses orthogonal init for the recurrent
kernel; we use glorot-uniform for both kernels. Initializer choice is a
training detail, not part of the behavioral contract (SURVEY.md §8).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from .conv import conv2d

Carry = Tuple[jax.Array, jax.Array]  # (h, c), each [B,H,W,F]


def _recurrent_act(x, kind: str):
    if kind == "sigmoid":
        return jax.nn.sigmoid(x)
    if kind == "hard_sigmoid":
        return jnp.clip(0.2 * x + 0.5, 0.0, 1.0)
    raise ValueError(f"unknown recurrent activation {kind!r}")


def lstm_gate_update_xla(gates: jax.Array, c: jax.Array,
                         recurrent_activation: str = "sigmoid"):
    """(c_new, h_new) from pre-activation gates [..., 4F] and c [..., F].

    Reference parity: the gate math of Keras ``ConvLSTM2D`` (SURVEY.md
    §3.3), gate order (i, f, g/candidate, o)::

        i, f, o = act_r(gates[i]), act_r(gates[f]), act_r(gates[o])
        c_new = f * c + i * tanh(gates[g]);  h_new = o * tanh(c_new)

    ``act_r`` is sigmoid, or ``hard_sigmoid`` (clip(0.2x + 0.5, 0, 1)) for
    Keras-2.0-era parity. Gate math runs in f32, but the upcast happens
    per-slice AFTER the gate tensor is read: casting the whole tensor first
    fuses the convert into the producing conv and materializes the 4F gates
    in f32 — doubling the dominant buffer's traffic under bf16 compute.
    """
    feat = c.shape[-1]

    def g32(k):
        return gates[..., k * feat: (k + 1) * feat].astype(jnp.float32)

    i = _recurrent_act(g32(0), recurrent_activation)
    f = _recurrent_act(g32(1), recurrent_activation)
    cand = jnp.tanh(g32(2))
    o = _recurrent_act(g32(3), recurrent_activation)
    c_new = f * c.astype(jnp.float32) + i * cand
    h_new = o * jnp.tanh(c_new)
    return c_new.astype(c.dtype), h_new.astype(c.dtype)


class ConvLSTMCell:
    """Functional ConvLSTM cell: params are a dict pytree, state is explicit."""

    @staticmethod
    def init(rng: jax.Array, kernel_size: int, in_channels: int, filters: int,
             dtype=jnp.float32) -> Dict[str, jax.Array]:
        kh = kw = kernel_size
        cout = 4 * filters
        rx, rh = jax.random.split(rng)
        lim_x = math.sqrt(6.0 / (kh * kw * in_channels + kh * kw * cout))
        lim_h = math.sqrt(6.0 / (kh * kw * filters + kh * kw * cout))
        kernel_x = jax.random.uniform(rx, (kh, kw, in_channels, cout), dtype,
                                      -lim_x, lim_x)
        kernel_h = jax.random.uniform(rh, (kh, kw, filters, cout), dtype,
                                      -lim_h, lim_h)
        # unit forget-gate bias (Keras unit_forget_bias=True)
        bias = jnp.zeros((cout,), dtype).at[filters: 2 * filters].set(1.0)
        return {"kernel_x": kernel_x, "kernel_h": kernel_h, "bias": bias}

    @staticmethod
    def init_state(batch: int, height: int, width: int, filters: int,
                   dtype=jnp.float32) -> Carry:
        shape = (batch, height, width, filters)
        return jnp.zeros(shape, dtype), jnp.zeros(shape, dtype)

    @staticmethod
    def apply(params: Dict[str, jax.Array], carry: Carry, x: jax.Array, *,
              recurrent_activation: str = "sigmoid"
              ) -> Tuple[Carry, jax.Array]:
        """One timestep: ((h,c), x[B,H,W,Cin]) -> ((h',c'), h')."""
        h, c = carry
        if "kernel_x_q" in params:  # int8-quantized cell (ops/quant.py)
            from .quant import conv2d_q

            # gate pre-activations in the compute dtype (bf16), as on the
            # float path: f32 gates at 4F channels would double the
            # dominant buffer's bytes
            qx = {"kernel_q": params["kernel_x_q"],
                  "w_scale": params["wx_scale"], "bias": params["bias"]}
            qh = {"kernel_q": params["kernel_h_q"],
                  "w_scale": params["wh_scale"]}
            if "x_scale" in params:
                qx["x_scale"] = params["x_scale"]
            if "h_scale" in params:
                qh["x_scale"] = params["h_scale"]
            gates = (conv2d_q(x, qx, out_dtype=x.dtype)
                     + conv2d_q(h, qh, out_dtype=x.dtype))
        else:
            gates = (conv2d(x, params["kernel_x"], params["bias"])
                     + conv2d(h.astype(x.dtype), params["kernel_h"]))
        c_new, h_new = lstm_gate_update_xla(gates, c, recurrent_activation)
        return (h_new, c_new), h_new
