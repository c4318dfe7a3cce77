"""Benchmark harness — streaming inference frames/sec at 512x512 on the GPU.

The timed region is the FULL streaming pipeline per frame on device:
ULSTMnet2D step (flagship default architecture) + softmax + threshold +
connected-component instance labeling + label compaction, with the LSTM
state carried across frames (donated buffers). Timing ends in
``block_until_ready``.

Prints ONE JSON line naming the device it ran on:
  {"metric": ..., "value": N, "unit": "frames/sec", "device": {...}}

Runs on an NVIDIA GPU only: a run on any other platform is refused, and
peak rates come from ``PEAKS``, keyed by ``device_kind`` (an unknown device
is an error, not a default).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

import jax
import jax.numpy as jnp

# Published dense (no sparsity) peaks, keyed by jax's device_kind. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, at its 700 W limit. A
# card capped below 700 W (nvidia-smi power.limit) cannot hold these clocks.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989e12,        # FLOP/s, tensor cores
        "int8": 1979e12,           # OP/s, tensor cores
        "float32": 495e12,         # FLOP/s, TF32 tensor cores
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak_rate(device_kind: str, dtype: str) -> float:
    """Published peak of ``dtype`` on ``device_kind``; unknown is an error."""
    if device_kind not in PEAKS:
        raise ValueError(f"unknown device kind {device_kind!r}: no published "
                         f"peak in bench.PEAKS (known: {sorted(PEAKS)})")
    return PEAKS[device_kind][dtype]


def device_info() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` as nvidia-smi reports them (no JAX involved)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def _apply_probe(nkp, probe: str):
    """Config-only roofline probes: clone the flagship with one region
    narrowed and bench UNTRAINED weights — a pure throughput probe locating
    where the step's time lives, never a quality claim.

    - half_enc0: encoder level 0 (ConvLSTM + down convs) channels halved —
      the full-resolution 512^2 encoder level, the biggest HBM working set
    - half_dec0: decoder level 0 conv stack halved — the full-resolution
      decoder level
    - half_l0:   both of the above
    """
    def halve(levels, i):
        levels[i] = [(k, f // 2) for k, f in levels[i]]

    if probe in ("half_enc0", "half_l0"):
        halve(nkp.lstm_kernels, 0)
        halve(nkp.down_conv_kernels, 0)
    if probe in ("half_dec0", "half_l0"):
        halve(nkp.up_conv_kernels, 0)
    if probe and probe not in ("half_enc0", "half_dec0", "half_l0"):
        raise ValueError(f"unknown probe {probe!r}")
    return nkp


def stream_config(nkp, dtype: str):
    """ModelConfig of the streaming step. 'int8': convs int8xint8->int32
    with dequant epilogues, bf16 elsewhere (ops/quant.py) — the same
    mapping as engine.infer.load_model."""
    from lstm_unet_tpu.models import ModelConfig

    return ModelConfig.make(
        nkp, dtype="bfloat16" if dtype == "int8" else dtype,
        quant="int8" if dtype == "int8" else "none")


def stream_step(cfg, ccl_method: str = "sweep"):
    """The production streaming step ``(params, state, frame) -> (state,
    labels)``, unjitted: per-lane on-device normalize + model + softmax +
    instance postprocess (same chain as engine.infer). Integer frames take
    the exact histogram quantile. batch>1 = concurrent independent streams
    on one device (the serving configuration of
    engine.infer.run_inference_batched). params is an explicit argument:
    closed-over arrays would be baked into the HLO as constants."""
    from lstm_unet_tpu.models import ULSTMnet2D
    from lstm_unet_tpu.ops.postprocess import postprocess_frame

    def step(params, state, frame):
        def norm(f):  # [H,W,1]
            if jnp.issubdtype(f.dtype, jnp.integer):
                from lstm_unet_tpu.io.preprocess import integer_percentile_bounds

                lo, hi = integer_percentile_bounds(f[:, :, 0], 1.0, 99.0)
            else:
                lo, hi = jnp.percentile(
                    f.astype(jnp.float32).reshape(-1), jnp.array([1.0, 99.0]))
            return (f.astype(jnp.float32) - lo) / jnp.maximum(hi - lo, 1e-6)

        frame = jax.vmap(norm)(frame)
        new_state, logits = ULSTMnet2D.step(params, state, frame, cfg)
        probs = jax.nn.softmax(logits, axis=-1)
        labels = jax.vmap(lambda p: postprocess_frame(
            p, cell_thresh=0.5, edge_thresh=0.3, min_cell_size=10,
            grow_iters=3, ccl_method=ccl_method))(probs)
        return new_state, labels

    return step


def prepare_stream_params(params, cfg, act_scales=None,
                          int8_keep_float: str = ""):
    """Pre-cast (or int8-quantize) float weights once, with the same helpers
    the inference engine uses."""
    if cfg.quant == "int8":
        from lstm_unet_tpu.ops.quant import quantize_params_int8

        return quantize_params_int8(params, act_scales,
                                    keep_float=int8_keep_float,
                                    float_dtype=cfg.compute_dtype)
    from lstm_unet_tpu.models.ulstm_unet import cast_params_for_inference

    return cast_params_for_inference(params, cfg.compute_dtype)


def calibration_scales(params, cfg, size: int):
    """Static int8 activation scales from a short float-model pass over the
    benchmark's synthetic distribution (engine.infer calibration)."""
    from lstm_unet_tpu.engine.infer import calibrate_act_scales
    from lstm_unet_tpu.io.synthetic import make_cell_sequence

    imgs, _ = make_cell_sequence(num_frames=4, height=size, width=size,
                                 num_cells=40, seed=7)
    return calibrate_act_scales(params, cfg,
                                [f.astype(np.float32) for f in imgs])


def build_pipeline(size: int, dtype: str, tiny: bool,
                   calibrated: bool = False, ccl_method: str = "sweep",
                   batch: int = 1, entry_layouts: bool = False,
                   int8_keep_float: str = "", probe: str = "", seed: int = 0):
    """The production streaming step, ready to run.

    Returns ``(fn, params, state)``: call ``fn(params, state, frame)`` with a
    raw uint16 frame batch [B,H,W,1] -> ``(state, labels)``. ``fn`` is a
    jitted function (``fn.lower`` works) unless ``entry_layouts``, where it
    is the AOT-compiled executable.
    """
    from lstm_unet_tpu.config import default_net_kernel_params, tiny_net_kernel_params
    from lstm_unet_tpu.models import ULSTMnet2D

    nkp = tiny_net_kernel_params() if tiny else default_net_kernel_params()
    if probe:
        nkp = _apply_probe(nkp, probe)
    cfg = stream_config(nkp, dtype)
    params = ULSTMnet2D.init(jax.random.PRNGKey(seed), cfg)
    state = ULSTMnet2D.init_state(cfg, batch, size, size)
    step = stream_step(cfg, ccl_method)
    act_scales = (calibration_scales(params, cfg, size)
                  if cfg.quant == "int8" and calibrated else None)
    params = prepare_stream_params(params, cfg, act_scales, int8_keep_float)
    if entry_layouts:
        # AOT-compile with AUTO entry layouts for the weights and device_put
        # them into the executable's preferred formats ONCE (no per-frame
        # in-program re-layout of conv kernels). Same mechanism as
        # engine.infer entry_layouts.
        from jax.experimental.layout import Format, Layout

        jauto = jax.jit(step, donate_argnums=(1,),
                        in_shardings=(Format(Layout.AUTO), None, None))
        sds = lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype)  # noqa: E731
        frame_sds = jax.ShapeDtypeStruct((batch, size, size, 1), jnp.uint16)
        comp = jauto.lower(jax.tree_util.tree_map(sds, params),
                           jax.tree_util.tree_map(sds, state),
                           frame_sds).compile()
        params = jax.device_put(params, comp.input_formats[0][0])
        return comp, params, state
    return jax.jit(step, donate_argnums=(1,)), jax.device_put(params), state


def make_frames(n: int, size: int, batch: int = 1) -> np.ndarray:
    from lstm_unet_tpu.io.synthetic import make_cell_sequence

    # raw uint16 frames, exactly what production streaming uploads: the
    # engine normalizes on device (integer frames take the exact histogram
    # quantile). batch>1: decorrelate the lanes by rolling each one down H — distinct
    # streams without B generator passes
    imgs, _ = make_cell_sequence(num_frames=n, height=size, width=size,
                                 num_cells=40, seed=7)
    frames = np.stack(imgs)[..., None, :, :, None]  # [n,1,H,W,1]
    if batch > 1:
        frames = np.concatenate(
            [np.roll(frames, (size // batch) * b, axis=2)
             for b in range(batch)], axis=1)
    return frames


def bench_train(size: int, dtype: str, tiny: bool, steps: int = 10,
                emit: bool = True, remat="full", B: int = 8, T: int = 7,
                entry_layouts: bool = False, adam_mu_dtype: str = "float32",
                mfu: bool = False, seed: int = 0):
    """Training-step throughput (remat BPTT on a synthetic batch).

    With ``emit`` prints its own JSON line (--mode train); the default
    bench mode calls it with emit=False and folds the number into the
    headline JSON line as train_* keys. ``mfu`` adds the HLO-counted FLOPs
    of the executed step (remat recompute included) and their rate over
    the device's published peak (``peak_rate``; an unknown device raises).
    """
    import optax

    from lstm_unet_tpu.config import default_net_kernel_params, tiny_net_kernel_params
    from lstm_unet_tpu.engine.train import make_train_step
    from lstm_unet_tpu.models import ModelConfig, ULSTMnet2D

    nkp = tiny_net_kernel_params() if tiny else default_net_kernel_params()
    cfg = ModelConfig.make(nkp, dtype=dtype)
    params = ULSTMnet2D.init(jax.random.PRNGKey(seed), cfg)
    opt = optax.adam(1e-4, mu_dtype=(jnp.bfloat16 if adam_mu_dtype ==
                                     "bfloat16" else None))
    opt_state = opt.init(params)
    remat_arg = {"full": True, "none": False}.get(remat, remat)
    step = make_train_step(cfg, opt, (0.15, 0.25, 0.6), remat=remat_arg,
                           entry_layouts=entry_layouts)
    state = ULSTMnet2D.init_state(cfg, B, size, size)
    img = jnp.zeros((B, T, size, size, 1), jnp.float32) + 0.5
    seg = jnp.zeros((B, T, size, size), jnp.int32)
    ones = jnp.ones((B, T))
    last = jnp.zeros((B,))
    params, opt_state, state, m = step(params, opt_state, state, img, seg,
                                       ones, ones, last)
    jax.block_until_ready(m)
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt_state, state, m = step(params, opt_state, state, img,
                                           seg, ones, ones, last)
    jax.block_until_ready((params, m))
    dt = time.perf_counter() - t0
    fps = steps * B * T / dt
    out = {
        "metric": f"training frames/sec @ {size}x{size} B{B} T{T} "
                  f"(flagship ULSTMnet2D, {dtype}, remat={remat} BPTT"
                  + (f", mu={adam_mu_dtype}" if adam_mu_dtype != "float32"
                     else "") + ")",
        "value": fps,
        "unit": "frames/sec",
        "device": device_info(),
    }
    if mfu:
        # abstract .lower() avoids touching the donated live buffers; this
        # is a second compile, so it is opt-in (--mfu)
        sds = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
            (params, opt_state, state, img, seg, ones, ones, last))
        ca = step.lower(*sds).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        flops = float(ca["flops"])
        out["train_flops_per_step"] = flops
        out["train_mfu"] = flops / (dt / steps) / peak_rate(
            jax.devices()[0].device_kind, dtype)
    if emit:
        print(json.dumps(out))
    return fps, f"{size}x{size} B{B} T{T} {dtype} remat"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--dtype", type=str, default="int8",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--calibrated", action="store_true", default=True,
                    help="int8 with precalibrated static activation scales")
    ap.add_argument("--no-calibrated", dest="calibrated", action="store_false")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--mode", choices=["infer", "train"], default="infer")
    ap.add_argument("--train_too", action="store_true", default=True,
                    help="append train_* keys to the headline JSON line")
    ap.add_argument("--no-train_too", dest="train_too", action="store_false")
    ap.add_argument("--remat_policy", type=str, default="full",
                    choices=["full", "save_outputs", "none"])
    ap.add_argument("--train_batch", type=int, default=8,
                    help="training bench batch B (the reference config is "
                         "B5)")
    ap.add_argument("--train_unroll", type=int, default=7,
                    help="training bench BPTT unroll T (reference is T7)")
    ap.add_argument("--adam_mu_dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"],
                    help="Adam first-moment storage dtype A/B")
    ap.add_argument("--mfu", action="store_true",
                    help="train mode: also report HLO flops/step and their "
                         "rate over the device's published peak (costs a "
                         "second compile)")
    ap.add_argument("--ccl", type=str, default="sweep",
                    choices=["sweep", "scan"],
                    help="CCL variant for the fused A/B (bit-identical)")
    ap.add_argument("--int8_conv", type=str, default="conv",
                    choices=["conv", "dots", "auto"],
                    help="int8 conv lowering A/B: XLA conv vs shifted-tap "
                         "dot_general (bit-identical, ops/quant.py)")
    ap.add_argument("--int8_keep_float", type=str, default="",
                    help="mixed-precision int8: comma-separated site "
                         "prefixes kept bf16 (e.g. 'encoder/0')")
    ap.add_argument("--batch", type=int, default=1,
                    help="concurrent independent streams on the device "
                         "(serving config); value = AGGREGATE frames/sec")
    ap.add_argument("--entry_layouts", action="store_true",
                    help="AOT-compile with AUTO entry layouts for the "
                         "weights — A/B knob")
    ap.add_argument("--conv_method", type=str, default="conv",
                    choices=["conv", "dots", "auto"],
                    help="FLOAT conv lowering A/B (ops/conv.py): applies to "
                         "bf16 inference and the training step")
    ap.add_argument("--probe", type=str, default="",
                    choices=["", "half_enc0", "half_dec0", "half_l0"],
                    help="roofline probe: bench a config-only clone with the "
                         "named full-res region's channels halved (untrained "
                         "weights — throughput attribution only)")
    args = ap.parse_args()

    from lstm_unet_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures an NVIDIA GPU; JAX's default "
                         f"device is {dev.platform!r} ({dev.device_kind})")
    peak_rate(dev.device_kind, "bfloat16")  # refuse an unknown card early
    if args.int8_conv != "conv":
        from lstm_unet_tpu.ops import quant

        quant.INT8_CONV_METHOD = args.int8_conv
    if args.conv_method != "conv":
        from lstm_unet_tpu.ops import conv as conv_mod

        conv_mod.CONV_METHOD = args.conv_method
    run_bench(args)


def run_bench(args):
    if args.mode == "train":
        bench_train(256 if args.size == 512 else args.size,
                    "bfloat16" if args.dtype == "int8" else args.dtype,
                    args.tiny, remat=args.remat_policy,
                    B=args.train_batch, T=args.train_unroll,
                    entry_layouts=args.entry_layouts,
                    adam_mu_dtype=args.adam_mu_dtype, mfu=args.mfu,
                    seed=args.seed)
        return

    fn, params, state = build_pipeline(
        args.size, args.dtype, args.tiny, args.calibrated, args.ccl,
        args.batch, args.entry_layouts, args.int8_keep_float, args.probe,
        seed=args.seed)
    frames = make_frames(min(args.frames, 16), args.size, args.batch)
    dev_frames = [jax.device_put(jnp.asarray(f)) for f in frames]

    # warm-up: compile + 2 steady-state steps
    state, labels = fn(params, state, dev_frames[0])
    state, labels = fn(params, state, dev_frames[1 % len(dev_frames)])
    jax.block_until_ready(labels)

    t0 = time.perf_counter()
    for i in range(args.frames):
        state, labels = fn(params, state, dev_frames[i % len(dev_frames)])
    # the final labels depend on every prior step through the state chain
    jax.block_until_ready((state, labels))
    dt = time.perf_counter() - t0

    fps = args.frames * args.batch / dt
    lanes = (f", {args.batch} concurrent streams aggregate"
             if args.batch > 1 else "")
    probe_tag = f", PROBE {args.probe}" if args.probe else ""
    out = {
        "metric": f"streaming inference frames/sec @ {args.size}x{args.size} "
                  f"(flagship ULSTMnet2D, {args.dtype}, on-device postprocess"
                  f"{lanes}{probe_tag})",
        "value": fps,
        "unit": "frames/sec",
        "device": device_info(),
        "gpu": gpu_name_and_power_limit(),
    }
    if args.train_too:
        tfps, tcfg = bench_train(
            256 if args.size == 512 else args.size,
            "bfloat16" if args.dtype == "int8" else args.dtype,
            args.tiny, steps=6, emit=False, remat=args.remat_policy,
            B=args.train_batch, T=args.train_unroll, seed=args.seed)
        out["train_value"] = tfps
        out["train_unit"] = "frames/sec"
        out["train_config"] = tcfg
    print(json.dumps(out))


if __name__ == "__main__":
    main()
