"""ULSTMnet2D — recurrent ConvLSTM U-Net.

Reference parity: ``Networks.py::ULSTMnet2D`` + ``DownBlock2D``/``UpBlock2D``
(SURVEY.md §2 "Full model", §3.3 forward pass):

    per encoder level i:  ConvLSTM(s) → conv stack → skip_i → 2x2 maxpool
    per decoder level i (reverse): upsample 2x → concat skip_i → conv stack
    head: 1x1 conv → num_classes logits (softmax taken by callers)

The only cross-frame dataflow is the per-level (h, c) ConvLSTM state
(SURVEY.md §3.3), so the whole per-frame U-Net is the ``lax.scan`` body and
the state is the scan carry — this is the functional shape of the reference's
Keras stateful layers:

- reference ``reset_states_per_batch(is_last)`` → ``reset_lanes`` (pure)
- reference ``get_states``/``set_states``       → state is already a value
- streaming inference = calling ``step`` forever with the carried pytree
  (O(1) memory in sequence length, SURVEY.md §8.4)

Topology is driven by the reference's ``net_kernel_params`` schema verbatim.
Architecture note: the reference pools after every encoder level, making the
deepest level the bottleneck ("bottleneck convs" of SURVEY.md §3.3 [M] —
here they are the deepest up_conv stack); inputs must be padded to a
multiple of 2**depth (engine does reflect-padding, reference: Inference2D
pad-to-2^depth [M]).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp

from jax.ad_checkpoint import checkpoint_name

from ..config import NetKernelParams
from ..ops.conv import activate, conv2d, init_conv, max_pool_2x2, upsample_2x
from ..ops.convlstm import ConvLSTMCell

# State: one list entry per encoder level; each is a list of (h, c) per
# ConvLSTM layer in that level.
State = List[List[Tuple[jax.Array, jax.Array]]]
Params = Dict[str, Any]


@dataclass(frozen=True)
class ModelConfig:
    """Static model options (hashable → usable as a jit static arg)."""

    net_kernel_params_json: str  # NetKernelParams as a canonical JSON string
    in_channels: int = 1
    num_classes: int = 3
    activation: str = "leaky_relu"
    recurrent_activation: str = "sigmoid"
    upsample: str = "nearest"
    # Optional per-conv LayerNorm (over channels, learnable scale/bias).
    # The reference's use of BatchNorm is unverified [M — SURVEY.md §7
    # hard-part #4]; LayerNorm is the batch-size/sharding-independent choice.
    norm: str = "none"
    dtype: str = "float32"
    # 'int8': convs run int8xint8->int32 with f32 dequant epilogues
    # (ops/quant.py); everything else follows `dtype`. Inference-only —
    # params must be quantized via quantize_params_int8.
    quant: str = "none"
    # decoder skip-concat convs as two channel-sliced convs summed (same
    # math, no concat buffer / layout copy — the r1 split-gate-conv lesson)
    split_skip_convs: bool = False
    # LSTM carry dtype: 'auto' follows `dtype`; 'float32' keeps (h, c) in f32
    # under bf16 compute — the cell state accumulates across an unbounded
    # stream, so drift matters for very long sequences (gate math always
    # runs in f32 internally either way)
    state_dtype: str = "auto"

    @staticmethod
    def make(nkp: NetKernelParams, **kw) -> "ModelConfig":
        import json

        return ModelConfig(net_kernel_params_json=json.dumps(nkp.to_dict()), **kw)

    @property
    def nkp(self) -> NetKernelParams:
        import json

        return NetKernelParams.from_dict(json.loads(self.net_kernel_params_json))

    @property
    def compute_dtype(self):
        return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[self.dtype]

    @property
    def carry_dtype(self):
        if self.state_dtype == "auto":
            return self.compute_dtype
        return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[self.state_dtype]


def _maybe_add_norm(conv_params: Dict[str, jax.Array], filters: int,
                    cfg: "ModelConfig") -> Dict[str, jax.Array]:
    if cfg.norm == "layernorm":
        conv_params["ln_scale"] = jnp.ones((filters,), jnp.float32)
        conv_params["ln_bias"] = jnp.zeros((filters,), jnp.float32)
    elif cfg.norm != "none":
        raise ValueError(f"unknown norm {cfg.norm!r}")
    return conv_params


def _collect(collect: Dict[str, jax.Array] | None, site: str, x: jax.Array):
    """Record max|x| for int8 activation-scale calibration (ops/quant.py)."""
    if collect is not None:
        collect[site] = jnp.max(jnp.abs(x.astype(jnp.float32)))


def _apply_conv(x: jax.Array, conv: Dict[str, jax.Array],
                collect: Dict[str, jax.Array] | None = None,
                site: str = "") -> jax.Array:
    """Dispatch float vs int8-quantized conv (param dicts self-describe)."""
    _collect(collect, site, x)
    if "kernel_q" in conv:
        from ..ops.quant import conv2d_q

        return conv2d_q(x, conv, out_dtype=x.dtype)
    return conv2d(x, conv["kernel"], conv["bias"])


def _norm_act(x: jax.Array, conv: Dict[str, jax.Array],
              cfg: "ModelConfig") -> jax.Array:
    if "ln_scale" in conv:
        x32 = x.astype(jnp.float32)
        mu = jnp.mean(x32, axis=-1, keepdims=True)
        var = jnp.var(x32, axis=-1, keepdims=True)
        x = ((x32 - mu) * jax.lax.rsqrt(var + 1e-6) * conv["ln_scale"]
             + conv["ln_bias"]).astype(x.dtype)
    return activate(x, cfg.activation)


def _conv_block(x: jax.Array, conv: Dict[str, jax.Array],
                cfg: "ModelConfig",
                collect: Dict[str, jax.Array] | None = None,
                site: str = "") -> jax.Array:
    """conv → optional channel LayerNorm → activation."""
    return _norm_act(_apply_conv(x, conv, collect, site), conv, cfg)


def _conv_block_first_decoder(x, skip, conv, cfg, collect=None, site=""):
    if cfg.split_skip_convs:
        return _conv_block_pair(x, skip, conv, cfg, collect, site)
    return _conv_block(jnp.concatenate([x, skip], axis=-1), conv, cfg,
                       collect, site)


def _conv_block_pair(a: jax.Array, b: jax.Array, conv: Dict[str, jax.Array],
                     cfg: "ModelConfig",
                     collect: Dict[str, jax.Array] | None = None,
                     site: str = "") -> jax.Array:
    """``conv(concat([a, b]))`` as two channel-sliced convs summed — exactly
    the same math, but no concat buffer and no layout copy of the skip
    (the split-gate-convs lesson of r1, applied to the decoder; BASELINE.md).
    """
    _collect(collect, site + ".a", a)
    _collect(collect, site + ".b", b)
    if "kernel_q" in conv:
        from ..ops.quant import conv2d_q_pair

        y = conv2d_q_pair(a, b, conv, out_dtype=a.dtype)
    else:
        ca = a.shape[-1]
        k = conv["kernel"]
        y = (conv2d(a, k[:, :, :ca], conv["bias"])
             + conv2d(b.astype(a.dtype), k[:, :, ca:]))
    return _norm_act(y, conv, cfg)


def cast_params_for_inference(params: Params, dtype) -> Params:
    """Pre-cast conv/LSTM weights to the compute dtype (conv2d casts per call
    anyway, so this is identical math with the casts hoisted out of the hot
    loop). LayerNorm scale/bias are EXCLUDED — _conv_block applies them in
    f32, so truncating them would perturb logits."""

    def rec(node):
        if isinstance(node, dict):
            return {
                k: (v if k.startswith("ln_") else rec(v))
                for k, v in node.items()
            }
        if isinstance(node, list):
            return [rec(v) for v in node]
        if hasattr(node, "dtype") and jnp.issubdtype(node.dtype, jnp.floating):
            return node.astype(dtype)
        return node

    return rec(params)


class ULSTMnet2D:
    """Functional model: ``params`` and ``state`` are explicit pytrees."""

    # -- init ---------------------------------------------------------------

    @staticmethod
    def init(rng: jax.Array, cfg: ModelConfig) -> Params:
        nkp = cfg.nkp
        params: Params = {"encoder": [], "decoder": [], "head": None}
        cin = cfg.in_channels
        skip_channels: List[int] = []

        for lvl in range(nkp.depth):
            level: Dict[str, Any] = {"lstm": [], "convs": []}
            for (k, f) in nkp.lstm_kernels[lvl]:
                rng, sub = jax.random.split(rng)
                level["lstm"].append(ConvLSTMCell.init(sub, k, cin, f))
                cin = f
            for (k, f) in nkp.down_conv_kernels[lvl]:
                rng, sub = jax.random.split(rng)
                level["convs"].append(_maybe_add_norm(init_conv(sub, k, k, cin, f), f, cfg))
                cin = f
            skip_channels.append(cin)
            params["encoder"].append(level)

        # decoder, deepest level first at apply time; params stored per level
        # index (same indexing as up_conv_kernels)
        dec_cin = skip_channels[-1]  # pooled deepest feature
        for lvl in reversed(range(nkp.depth)):
            level = {"convs": []}
            c = dec_cin + skip_channels[lvl]  # upsampled + skip concat
            for (k, f) in nkp.up_conv_kernels[lvl]:
                rng, sub = jax.random.split(rng)
                level["convs"].append(_maybe_add_norm(init_conv(sub, k, k, c, f), f, cfg))
                c = f
            dec_cin = c
            params["decoder"].insert(0, level)

        rng, sub = jax.random.split(rng)
        params["head"] = init_conv(sub, 1, 1, dec_cin, cfg.num_classes)
        return params

    @staticmethod
    def init_state(cfg: ModelConfig, batch: int, height: int, width: int) -> State:
        nkp = cfg.nkp
        if height % (2 ** nkp.depth) or width % (2 ** nkp.depth):
            raise ValueError(
                f"H,W must be multiples of 2^depth={2 ** nkp.depth}, got {height}x{width}")
        dt = cfg.carry_dtype
        state: State = []
        h, w = height, width
        for lvl in range(nkp.depth):
            state.append([
                ConvLSTMCell.init_state(batch, h, w, f, dt)
                for (_, f) in nkp.lstm_kernels[lvl]
            ])
            h, w = h // 2, w // 2
        return state

    # -- state management (reference: Networks.py state API [M]) ------------

    @staticmethod
    def reset_lanes(state: State, is_last: jax.Array) -> State:
        """Zero state for finished batch lanes (reference:
        ``reset_states_per_batch(is_last)`` [M]). ``is_last`` is [B]."""
        def zero(x):
            mask = is_last.reshape((-1,) + (1,) * (x.ndim - 1)).astype(x.dtype)
            return x * (1 - mask)

        return jax.tree_util.tree_map(zero, state)

    # -- forward ------------------------------------------------------------

    @staticmethod
    def step(params: Params, state: State, frame: jax.Array, cfg: ModelConfig,
             collect_scales: Dict[str, jax.Array] | None = None
             ) -> Tuple[State, jax.Array]:
        """One frame: ([B,H,W,C]) → (new_state, logits [B,H,W,num_classes]).

        ``collect_scales``: a dict the caller owns; when given, every conv
        site records max|input| into it under a stable site key — the int8
        activation-scale calibration pass (ops/quant.py, engine.infer).
        """
        dt = cfg.compute_dtype
        x = frame.astype(dt)
        new_state: State = []
        skips: List[jax.Array] = []

        for lvl, level in enumerate(params["encoder"]):
            lvl_state = []
            for j, cell in enumerate(level["lstm"]):
                _collect(collect_scales, f"encoder/{lvl}/lstm/{j}/x", x)
                _collect(collect_scales, f"encoder/{lvl}/lstm/{j}/h",
                         state[lvl][j][0])
                carry, x = ConvLSTMCell.apply(
                    cell, state[lvl][j], x,
                    recurrent_activation=cfg.recurrent_activation)
                lvl_state.append(carry)
                x = x.astype(dt)  # carry may be f32 (state_dtype='float32')
                # no-op outside jax.checkpoint; under the 'save_outputs'
                # remat policy these are the saved residuals (BPTT then
                # recomputes only gate math/pool/upsample/activations)
                x = checkpoint_name(x, "lstm_out")
            for j, conv in enumerate(level["convs"]):
                x = _conv_block(x, conv, cfg, collect_scales,
                                f"encoder/{lvl}/convs/{j}")
            x = checkpoint_name(x, "skip")
            skips.append(x)
            new_state.append(lvl_state)
            x = max_pool_2x2(x)

        for lvl in reversed(range(len(params["decoder"]))):
            x = upsample_2x(x, cfg.upsample)
            convs = params["decoder"][lvl]["convs"]
            x = _conv_block_first_decoder(x, skips[lvl], convs[0], cfg,
                                          collect_scales,
                                          f"decoder/{lvl}/convs/0")
            for j, conv in enumerate(convs[1:], start=1):
                x = _conv_block(x, conv, cfg, collect_scales,
                                f"decoder/{lvl}/convs/{j}")

        logits = _apply_conv(x, params["head"], collect_scales, "head")
        return new_state, logits.astype(jnp.float32)

    @staticmethod
    def apply(params: Params, state: State, x: jax.Array, cfg: ModelConfig,
              remat: bool | str = False) -> Tuple[State, jax.Array]:
        """Unrolled window: ([B,T,H,W,C]) → (new_state, logits [B,T,H,W,K]).

        ``lax.scan`` over T with the per-frame U-Net as the body
        (SURVEY.md §3.3: the only cross-frame dataflow is the LSTM state).
        ``remat`` rematerializes the body in the backward pass to trade
        FLOPs for HBM during BPTT:
          - False: save every intermediate
          - True / 'full': save nothing, recompute the whole body
          - 'save_outputs': save the per-level ConvLSTM and conv-stack
            outputs (the checkpoint_name sites in ``step``) and recompute
            only the cheap glue — a middle point whose extra memory is the
            per-frame skip/lstm tensors (~0.75 GB at flagship B5/T7/256²)
        """
        def body(carry, frame):
            new_carry, logits = ULSTMnet2D.step(params, carry, frame, cfg)
            return new_carry, logits

        if remat == "save_outputs":
            body = jax.checkpoint(
                body, policy=jax.checkpoint_policies.save_only_these_names(
                    "lstm_out", "skip"))
        elif remat:
            body = jax.checkpoint(body)
        xs = jnp.moveaxis(x, 1, 0)  # [T,B,H,W,C]
        state, logits = jax.lax.scan(body, state, xs)
        return state, jnp.moveaxis(logits, 0, 1)
