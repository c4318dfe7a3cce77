"""On-card smoke test of the main path, at the flagship's full width.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py           # one card: phases 0-4
    python chip_smoke.py --four    # four cards: data-parallel training only

Phases, all in this one process (one process per card):

0. The card: nvidia-smi name and power limit, JAX version and devices, which
   optional packages import. Exits non-zero unless JAX's device is a GPU.
1. Compile only, before anything executes: the flagship streaming step
   (bench.stream_step: normalize, model, softmax, postprocess) at 512² in
   bf16 and int8 with calibrated scales, the B8T7 256² bf16 remat train
   step, and the off-by-default knobs (entry_layouts, conv_method='dots',
   int8_keep_float). Prints each compile time and memory analysis.
2. The main path end to end: a synthetic CTC dataset (512² frames, fixed
   seed) → ``train2d.main`` for a few flagship B8T7 256² bf16 steps with
   checkpoints → ``inference2d.main`` from that checkpoint in bf16 and in
   int8 (--calibrate 8) → one uint16 mask per frame.
3. Correctness on the card against a plain float32 reference of the same
   seeded weights at ``jax.default_matmul_precision("highest")``: streaming
   logits after 8 frames (f32 vs the CPU, bf16 and int8 vs the reference),
   one B8T7 train step's loss and gradient norm (bf16 vs f32), and the
   ``gpu``-marked tests (postprocess labels vs the CPU, matmul vs scatter
   relabel).
4. Times of the plain XLA versions of the removed kernels at flagship
   widths: the level-0 ConvLSTM step and its gate update, the step's
   forward+backward, connected components, and the two relabel paths.

The last line of stdout is ``{"ok": true, "device": {...}}``; any failed
check raises, so the script exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import importlib.util
import io
import json
import os
import re
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np

import jax
import jax.numpy as jnp

import bench
from lstm_unet_tpu.checkpoint.ckpt import flatten_tree
from lstm_unet_tpu.config import (CTCParams, default_net_kernel_params,
                                  tiny_net_kernel_params)
from lstm_unet_tpu.engine.train import make_optimizer, make_train_step
from lstm_unet_tpu.io.preprocess import (instance_to_three_class,
                                         percentile_normalize_np)
from lstm_unet_tpu.io.synthetic import make_cell_sequence, write_ctc_dataset
from lstm_unet_tpu.io.tiff import read_tiff
from lstm_unet_tpu.models import ModelConfig, ULSTMnet2D
from lstm_unet_tpu.ops.ccl import (connected_components, relabel_compact,
                                   relabel_compact_mm)
from lstm_unet_tpu.ops.convlstm import ConvLSTMCell, lstm_gate_update_xla
from lstm_unet_tpu.ops.postprocess import postprocess_frame
from lstm_unet_tpu.utils.compile_cache import enable_compile_cache

REPO = os.path.dirname(os.path.abspath(__file__))
CLASS_WEIGHTS = (0.15, 0.25, 0.6)

# Tolerances, each on rel_err = max|a - ref| / max|ref| (or |a - ref| / |ref|
# for scalars), with its reason. Measured on an H100 at 400 W (PR 1): f32
# 'highest' vs CPU 2.3e-6, f32 at default precision (TF32) vs CPU 1.2e-3,
# bf16 stream 1.0e-2, int8 stream 0.16, bf16 train loss 2.4e-6 and grad
# norm 1.8e-3.
# - f32 on the card at "highest" vs f32 on the CPU: both are full f32, only
#   the summation order differs (cuDNN vs Eigen). TF32 (10-bit mantissa)
#   anywhere in the chain lands ~10x above this; phase 3 checks that it does.
TOL_F32_VS_CPU = 1e-4
# - bf16 streaming vs the f32 reference: bf16 keeps an 8-bit mantissa
#   (~4e-3 relative per rounding) through 4 encoder/decoder levels and 8
#   recurrent frames.
TOL_BF16_STREAM = 5e-2
# - int8 streaming vs the f32 reference: per-tensor int8 activations
#   quantize every conv input to 1/127 of its range, through every conv of
#   8 recurrent frames (random weights keep the logits small, ~0.05).
TOL_INT8_STREAM = 2.5e-1
# - one B8T7 bf16 train step vs the f32 reference: the loss is a mean over
#   B*T*H*W = 3.7M pixels, so per-pixel bf16 rounding averages out; the
#   gradient norm sums bf16-rounded backward convs through 7 unrolled
#   frames.
TOL_TRAIN_LOSS = 2e-5
TOL_TRAIN_GNORM = 1e-2


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of one smoke run; ``FLAGSHIP`` on the card, ``TINY`` in tests."""

    tiny: bool = False
    stream_hw: int = 512
    train_hw: int = 256
    batch: int = 8
    unroll: int = 7
    ref_frames: int = 8
    dataset_frames: int = 12
    cells: int = 40
    train_steps: int = 4
    save_every: int = 2
    calib_frames: int = 8
    timing_iters: int = 20

    @property
    def nkp(self):
        return tiny_net_kernel_params() if self.tiny else \
            default_net_kernel_params()


FLAGSHIP = Sizes()
TINY = Sizes(tiny=True, stream_hw=64, train_hw=32, batch=2, unroll=3,
             ref_frames=3, dataset_frames=6, cells=4, train_steps=2,
             save_every=1, calib_frames=2, timing_iters=2)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, ref) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-30))


def check(name: str, value: float, tol: float) -> None:
    ok = value <= tol
    log(f"  {name}: {value:.3e} (tolerance {tol:.2g}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} = {value:.3e} exceeds {tol:.2g}")


def timed(fn, *args, iters: int) -> float:
    """Seconds per call of ``fn(*args)``, after a warm-up call; the timed
    window ends in ``block_until_ready``."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


# ---------------------------------------------------------------- phase 0


def phase0_card() -> Dict:
    log("phase0: the card")
    log(f"  python {sys.version.split()[0]}, jax {jax.__version__}")
    log(f"  jax.devices(): {jax.devices()}")
    for mod in ("orbax", "cv2", "PIL", "tensorboardX", "grain"):
        found = importlib.util.find_spec(mod) is not None
        log(f"  optional package {mod}: {'present' if found else 'absent'}")
    dev = bench.device_info()
    if dev["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: JAX's device is {dev['platform']!r}, "
                         "not a GPU — nothing to check here")
    log(f"  nvidia-smi: {bench.gpu_name_and_power_limit()}")
    return dev


# ---------------------------------------------------------------- phase 1


def _abstract_params(cfg, act_scales=None, keep_float=""):
    return jax.eval_shape(lambda: bench.prepare_stream_params(
        ULSTMnet2D.init(jax.random.PRNGKey(0), cfg), cfg, act_scales,
        keep_float))


def _site_names(cfg, hw: int):
    """Conv-site names the int8 calibration records (shapes only)."""
    fcfg = dataclasses.replace(cfg, quant="none")

    def collect(p, s, x):
        c = {}
        ULSTMnet2D.step(p, s, x, fcfg, collect_scales=c)
        return c

    p = jax.eval_shape(lambda: ULSTMnet2D.init(jax.random.PRNGKey(0), fcfg))
    s = jax.eval_shape(lambda: ULSTMnet2D.init_state(fcfg, 1, hw, hw))
    return sorted(jax.eval_shape(
        collect, p, s, jax.ShapeDtypeStruct((1, hw, hw, 1), jnp.float32)))


def compile_stream(sz: Sizes, dtype: str, keep_float: str = "",
                   layouts: bool = False):
    """Lower + compile the streaming step from shapes alone."""
    cfg = bench.stream_config(sz.nkp, dtype)
    scales = ({k: 1.0 for k in _site_names(cfg, sz.stream_hw)}
              if cfg.quant == "int8" else None)
    p = _abstract_params(cfg, scales, keep_float)
    s = jax.eval_shape(lambda: ULSTMnet2D.init_state(
        cfg, 1, sz.stream_hw, sz.stream_hw))
    frame = jax.ShapeDtypeStruct((1, sz.stream_hw, sz.stream_hw, 1),
                                 jnp.uint16)
    kw = {}
    if layouts:
        from jax.experimental.layout import Format, Layout

        kw["in_shardings"] = (Format(Layout.AUTO), None, None)
    fn = jax.jit(bench.stream_step(cfg), donate_argnums=(1,), **kw)
    return fn.lower(p, s, frame).compile()


def train_params(sz: Sizes, **kw) -> CTCParams:
    return CTCParams(net_kernel_params=sz.nkp, crop_size=(sz.train_hw,) * 2,
                     batch_size=sz.batch, unroll_len=sz.unroll, **kw)


def compile_train(sz: Sizes, dtype: str = "bfloat16"):
    """Lower + compile the Trainer's step (same optimizer, bf16 batch
    upload) from shapes alone."""
    p = train_params(sz, dtype=dtype)
    cfg = ModelConfig.make(sz.nkp, dtype=dtype)
    opt = make_optimizer(p)
    step = make_train_step(cfg, opt, CLASS_WEIGHTS, remat=True)
    params = jax.eval_shape(lambda: ULSTMnet2D.init(jax.random.PRNGKey(0),
                                                    cfg))
    opt_state = jax.eval_shape(opt.init, params)
    B, T, hw = sz.batch, sz.unroll, sz.train_hw
    state = jax.eval_shape(lambda: ULSTMnet2D.init_state(cfg, B, hw, hw))
    img_dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    batch = (jax.ShapeDtypeStruct((B, T, hw, hw, 1), img_dt),
             jax.ShapeDtypeStruct((B, T, hw, hw), jnp.int8),
             jax.ShapeDtypeStruct((B, T), jnp.float32),
             jax.ShapeDtypeStruct((B, T), jnp.float32),
             jax.ShapeDtypeStruct((B,), jnp.float32))
    return step.lower(params, opt_state, state, *batch).compile()


def _report_compile(name: str, build) -> None:
    t0 = time.perf_counter()
    compiled = build()
    dt = time.perf_counter() - t0
    m = compiled.memory_analysis()
    log(f"  {name}: compiled in {dt:.1f} s; memory: "
        f"args {m.argument_size_in_bytes / 2**20:.1f} MiB, "
        f"outputs {m.output_size_in_bytes / 2**20:.1f} MiB, "
        f"temps {m.temp_size_in_bytes / 2**20:.1f} MiB, "
        f"aliased {m.alias_size_in_bytes / 2**20:.1f} MiB, "
        f"code {m.generated_code_size_in_bytes / 2**20:.1f} MiB")


def phase1_compile(sz: Sizes) -> None:
    from lstm_unet_tpu.ops import conv as conv_mod

    log(f"phase1: compile only ({sz.stream_hw}² stream, "
        f"B{sz.batch}T{sz.unroll} {sz.train_hw}² train)")
    _report_compile("stream bf16", lambda: compile_stream(sz, "bfloat16"))
    _report_compile("stream int8 (static scales, every level incl. Cin=1)",
                    lambda: compile_stream(sz, "int8"))
    _report_compile("train bf16 remat", lambda: compile_train(sz))
    _report_compile("knob entry_layouts (bf16 stream, AUTO weight layouts)",
                    lambda: compile_stream(sz, "bfloat16", layouts=True))
    _report_compile("knob int8_keep_float=encoder/0",
                    lambda: compile_stream(sz, "int8", keep_float="encoder/0"))
    saved = conv_mod.CONV_METHOD
    conv_mod.set_conv_method("dots")
    try:
        _report_compile("knob conv_method=dots (bf16 stream)",
                        lambda: compile_stream(sz, "bfloat16"))
    finally:
        conv_mod.set_conv_method(saved)


# ---------------------------------------------------------------- phase 2


class _Tee(io.TextIOBase):
    """Copy of everything written to stdout, for parsing the CLI logs."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def phase2_main_path(sz: Sizes, work: str, gpu: str) -> Dict:
    from lstm_unet_tpu.cli import inference2d, train2d

    log("phase2: the main path (train2d -> checkpoint -> inference2d)")
    root = os.path.join(work, "ctc")
    seq_dir, _ = write_ctc_dataset(
        root, num_frames=sz.dataset_frames, height=sz.stream_hw,
        width=sz.stream_hw, num_cells=sz.cells, seed=0)
    runs = os.path.join(work, "runs")
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        train2d.main([
            "--root_data_dir", root,
            "--train_sequence_list", "Synth-N2DH-SIM:01",
            "--crop_size", str(sz.train_hw), str(sz.train_hw),
            "--batch_size", str(sz.batch), "--unroll_len", str(sz.unroll),
            "--net_kernel_params", json.dumps(sz.nkp.to_dict()),
            "--dtype", "bfloat16", "--num_iterations", str(sz.train_steps),
            "--save_checkpoint_iteration", str(sz.save_every),
            "--print_to_console_interval", "1",
            "--validation_interval", "1000000000",
            "--write_to_tb_interval", "1000000000",
            "--root_save_dir", runs, "--experiment_name", "smoke",
            "--seed", "0"])
    train_wall = time.perf_counter() - t0
    fps = [float(x) for x in re.findall(r"\(([0-9.]+) frames/s\)",
                                        tee.buf.getvalue())]
    if len(fps) != sz.train_steps:
        raise AssertionError(f"expected {sz.train_steps} step logs, got "
                             f"{len(fps)}")
    ckpt = glob.glob(os.path.join(runs, "smoke_*", "ckpt"))[0]
    steps = sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())
    if not steps or steps[-1] != sz.train_steps:
        raise AssertionError(f"checkpoints saved: {steps}")
    steady = fps[-1] / (sz.batch * sz.unroll)
    log(f"  train2d: {sz.train_steps} steps, checkpoints {steps}, "
        f"{train_wall:.1f} s wall incl. compile; last step {fps[-1]:.1f} "
        f"frames/s = {steady:.2f} steps/s [{gpu}; observation]")

    n_frames = len(glob.glob(os.path.join(seq_dir, "t*.tif")))
    out = {"train_steps_per_s": steady}
    for dtype, extra in (("bfloat16", []),
                         ("int8", ["--calibrate", str(sz.calib_frames)])):
        res = os.path.join(work, f"res_{dtype}")
        t0 = time.perf_counter()
        inference2d.main(["--model_path", ckpt, "--sequence_path", seq_dir,
                          "--output_path", res, "--dtype", dtype] + extra)
        wall = time.perf_counter() - t0
        masks = sorted(glob.glob(os.path.join(res, "mask*.tif")))
        if len(masks) != n_frames:
            raise AssertionError(f"{dtype}: {len(masks)} masks for "
                                 f"{n_frames} frames")
        for m in masks:
            a = read_tiff(m)
            if a.dtype != np.uint16 or a.shape != (sz.stream_hw,) * 2:
                raise AssertionError(f"{m}: {a.dtype} {a.shape}")
        log(f"  inference2d {dtype}: {len(masks)} uint16 masks, "
            f"{wall:.1f} s wall incl. compile"
            + (" and calibration" if extra else "") + f" [{gpu}]")
        out[f"infer_{dtype}_wall_s"] = wall
    return out


# ---------------------------------------------------------------- phase 3


def reference_frames(sz: Sizes) -> np.ndarray:
    """Normalized float frames [T,H,W] of a seeded synthetic sequence."""
    imgs, _ = make_cell_sequence(num_frames=sz.ref_frames,
                                 height=sz.stream_hw, width=sz.stream_hw,
                                 num_cells=sz.cells, seed=3)
    return np.stack([percentile_normalize_np(f) for f in imgs])


def stream_logits(params, cfg, frames: np.ndarray, device) -> np.ndarray:
    """Model logits after streaming ``frames`` through the step on
    ``device`` (params already prepared for ``cfg``)."""
    step = jax.jit(lambda p, s, x: ULSTMnet2D.step(p, s, x, cfg))
    p = jax.device_put(params, device)
    h, w = frames.shape[1:]
    s = jax.device_put(ULSTMnet2D.init_state(cfg, 1, h, w), device)
    logits = None
    for f in frames:
        s, logits = step(p, s, jax.device_put(f[None, ..., None], device))
    return np.asarray(logits)


def host_params(cfg, seed: int = 0):
    """Seeded float32 weights, initialised on the CPU, as numpy."""
    with jax.default_device(jax.devices("cpu")[0]):
        return jax.tree_util.tree_map(
            np.asarray, ULSTMnet2D.init(jax.random.PRNGKey(seed), cfg))


def cpu_reference_logits(sz: Sizes) -> np.ndarray:
    cfg = ModelConfig.make(sz.nkp, dtype="float32")
    return stream_logits(host_params(cfg), cfg, reference_frames(sz),
                         jax.devices("cpu")[0])


def train_batch(sz: Sizes):
    """A B×T window of seeded synthetic sequences: normalized images and
    3-class targets."""
    imgs, segs = [], []
    for b in range(sz.batch):
        im, lab = make_cell_sequence(num_frames=sz.unroll,
                                     height=sz.train_hw, width=sz.train_hw,
                                     num_cells=max(sz.cells // 4, 2),
                                     seed=100 + b)
        imgs.append(np.stack([percentile_normalize_np(f) for f in im]))
        segs.append(np.stack([instance_to_three_class(l) for l in lab]))
    B, T = sz.batch, sz.unroll
    return (np.stack(imgs)[..., None].astype(np.float32),
            np.stack(segs).astype(np.int32), np.ones((B, T), np.float32),
            np.ones((B, T), np.float32), np.zeros((B,), np.float32))


def train_step_metrics(sz: Sizes, dtype: str) -> Dict[str, float]:
    """Loss and gradient norm of one Trainer step (same optimizer and
    upload dtypes as the Trainer, so phase 1's compile is reused)."""
    cfg = ModelConfig.make(sz.nkp, dtype=dtype)
    opt = make_optimizer(train_params(sz, dtype=dtype))
    step = make_train_step(cfg, opt, CLASS_WEIGHTS, remat=True)
    params = jax.device_put(host_params(cfg))
    state = ULSTMnet2D.init_state(cfg, sz.batch, sz.train_hw, sz.train_hw)
    img, seg, valid, full_seg, is_last = train_batch(sz)
    img = jnp.asarray(img, jnp.bfloat16 if dtype == "bfloat16" else
                      jnp.float32)
    _, _, _, m = step(params, opt.init(params), state, img,
                      jnp.asarray(seg, jnp.int8), jnp.asarray(valid),
                      jnp.asarray(full_seg), jnp.asarray(is_last))
    return {k: float(v) for k, v in m.items()}


def run_gpu_tests() -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest rc={rc})")


def phase3_correctness(sz: Sizes, cpu_logits, gpu: str) -> Dict:
    log("phase3: correctness on the card vs a float32 reference "
        "(precision 'highest')")
    frames = reference_frames(sz)
    f32 = ModelConfig.make(sz.nkp, dtype="float32")
    params = host_params(f32)
    dev = jax.devices()[0]
    with jax.default_matmul_precision("highest"):
        ref = stream_logits(params, f32, frames, dev)
    check("stream f32 'highest' vs CPU f32", rel_err(ref, cpu_logits),
          TOL_F32_VS_CPU)
    if dev.platform == "gpu":
        # control: the tolerance must catch TF32, the GPU's default for f32
        tf32 = rel_err(stream_logits(params, f32, frames, dev), cpu_logits)
        log(f"  control: stream f32 at default precision (TF32) vs CPU: "
            f"{tf32:.3e} — must exceed {TOL_F32_VS_CPU:.0e}")
        if tf32 <= TOL_F32_VS_CPU:
            raise AssertionError("TF32 control passed the f32 tolerance: "
                                 "the tolerance is too loose")
    out = {}
    for dtype, tol in (("bfloat16", TOL_BF16_STREAM),
                       ("int8", TOL_INT8_STREAM)):
        cfg = bench.stream_config(sz.nkp, dtype)
        scales = (bench.calibration_scales(params, cfg, sz.stream_hw)
                  if dtype == "int8" else None)
        p = bench.prepare_stream_params(params, cfg, scales)
        t0 = time.perf_counter()
        got = stream_logits(p, cfg, frames, dev)
        out[f"{dtype}_stream_s"] = time.perf_counter() - t0
        check(f"stream {dtype} vs f32 reference", rel_err(got, ref), tol)

    with jax.default_matmul_precision("highest"):
        m32 = train_step_metrics(sz, "float32")
    m16 = train_step_metrics(sz, "bfloat16")
    log(f"  train step f32: loss {m32['loss']:.6f} gnorm "
        f"{m32['grad_norm']:.6f}; bf16: loss {m16['loss']:.6f} gnorm "
        f"{m16['grad_norm']:.6f}")
    check("train bf16 loss vs f32",
          abs(m16["loss"] - m32["loss"]) / abs(m32["loss"]), TOL_TRAIN_LOSS)
    check("train bf16 grad norm vs f32",
          abs(m16["grad_norm"] - m32["grad_norm"]) / abs(m32["grad_norm"]),
          TOL_TRAIN_GNORM)
    log("  gpu-marked tests (postprocess vs CPU, relabel paths):")
    run_gpu_tests()
    return out


def postprocess_vs_cpu(hw: int, cells: int = 25, seed: int = 3):
    """Labels of ``postprocess_frame`` on GT-derived one-hot probabilities,
    on the default device and on the CPU, with the GT instance count. The
    default scene (512², 25 cells, seed 3) has no cell whose interior an
    overlapping neighbour cuts in two, so one component per GT cell."""
    _, labs = make_cell_sequence(num_frames=1, height=hw, width=hw,
                                 num_cells=cells, seed=seed)
    seg3 = instance_to_three_class(labs[0])
    probs = np.eye(3, dtype=np.float32)[seg3]
    n_gt = len(np.unique(labs[0][labs[0] > 0]))
    got = np.asarray(postprocess_frame(jnp.asarray(probs), min_cell_size=1))
    cpu = np.asarray(postprocess_frame(
        jax.device_put(probs, jax.devices("cpu")[0]), min_cell_size=1))
    return got, cpu, n_gt


def relabel_pair(hw: int, cells: int = 40, seed: int = 5, min_size: int = 10):
    """(matmul relabel, scatter relabel) of realistic raw CCL labels."""
    _, labs = make_cell_sequence(num_frames=1, height=hw, width=hw,
                                 num_cells=cells, seed=seed)
    interior = instance_to_three_class(labs[0]) == 1
    raw = connected_components(jnp.asarray(interior))
    return (relabel_compact_mm(raw, min_size=min_size),
            relabel_compact(raw, min_size=min_size))


# ---------------------------------------------------------------- phase 4


def phase4_kernels(sz: Sizes, gpu: str) -> Dict:
    log(f"phase4: plain XLA versions of the removed kernels [{gpu}]")
    hw, F = sz.stream_hw, sz.nkp.lstm_kernels[0][0][1]
    k = sz.nkp.lstm_kernels[0][0][0]
    bf = jnp.bfloat16
    cell = jax.tree_util.tree_map(
        lambda a: a.astype(bf),
        ConvLSTMCell.init(jax.random.PRNGKey(0), k, 1, F))
    key = jax.random.PRNGKey(1)
    x = jax.random.uniform(key, (1, hw, hw, 1), bf)
    h = jax.random.normal(key, (1, hw, hw, F), bf) * 0.5
    c = jax.random.normal(jax.random.PRNGKey(2), (1, hw, hw, F), bf)
    gates = jax.random.normal(key, (1, hw, hw, 4 * F), bf)
    out = {}

    fwd = jax.jit(lambda p, hc, x: ConvLSTMCell.apply(p, hc, x))
    out["level0_step_fwd_ms"] = 1e3 * timed(fwd, cell, (h, c), x,
                                            iters=sz.timing_iters)
    upd = jax.jit(lstm_gate_update_xla)
    out["gate_update_ms"] = 1e3 * timed(upd, gates, c, iters=sz.timing_iters)
    # bytes the gate update must move: read gates and c, write c' and h'
    moved = (gates.size + 3 * c.size) * 2
    floor_ms = 1e3 * moved / bench.PEAKS.get(
        jax.devices()[0].device_kind, {"hbm_bytes_per_s": np.inf}
    )["hbm_bytes_per_s"]

    B, thw = sz.batch, sz.train_hw
    xb = jax.random.uniform(key, (B, thw, thw, 1), bf)
    hb = jax.random.normal(key, (B, thw, thw, F), bf) * 0.5
    cb = jax.random.normal(key, (B, thw, thw, F), bf)

    def loss(p, hc, x):
        (h2, c2), _ = ConvLSTMCell.apply(p, hc, x)
        return jnp.sum(h2.astype(jnp.float32) ** 2) + jnp.sum(
            c2.astype(jnp.float32) ** 2)

    fb = jax.jit(jax.grad(loss, argnums=(0, 1)))
    out["level0_step_fwd_bwd_ms"] = 1e3 * timed(fb, cell, (hb, cb), xb,
                                                iters=sz.timing_iters)

    _, labs = make_cell_sequence(num_frames=1, height=hw, width=hw,
                                 num_cells=sz.cells, seed=5)
    mask = jnp.asarray(instance_to_three_class(labs[0]) == 1)
    out["ccl_ms"] = 1e3 * timed(connected_components, mask,
                                iters=sz.timing_iters)
    raw = connected_components(mask)
    out["relabel_matmul_ms"] = 1e3 * timed(
        lambda r: relabel_compact_mm(r, min_size=10), raw,
        iters=sz.timing_iters)
    out["relabel_scatter_ms"] = 1e3 * timed(
        lambda r: relabel_compact(r, min_size=10), raw,
        iters=sz.timing_iters)
    frames = [jnp.asarray(f) for f in bench.make_frames(4, hw)]
    for dtype in ("bfloat16", "int8"):
        fn, p, st = bench.build_pipeline(hw, dtype, sz.tiny, calibrated=True)

        def stream(st, fn=fn, p=p):
            for f in frames:
                st, labels = fn(p, st, f)
            return st, labels

        st = stream(st)[0]
        t0 = time.perf_counter()
        for _ in range(sz.timing_iters // 4 or 1):
            st, labels = stream(st)
        jax.block_until_ready(labels)
        n = len(frames) * (sz.timing_iters // 4 or 1)
        out[f"stream_{dtype}_fps"] = n / (time.perf_counter() - t0)
        log(f"  streaming step (normalize+model+postprocess) {hw}² {dtype}: "
            f"{out[f'stream_{dtype}_fps']:.1f} frames/s [observation]")
    log(f"  level-0 ConvLSTM step fwd, {hw}² F={F} bf16 B1: "
        f"{out['level0_step_fwd_ms']:.3f} ms")
    log(f"  gate update alone (lstm_gate_update_xla), {hw}² 4F={4 * F}: "
        f"{out['gate_update_ms']:.3f} ms (HBM floor {floor_ms:.3f} ms)")
    log(f"  level-0 ConvLSTM step fwd+bwd, {thw}² B{B}: "
        f"{out['level0_step_fwd_bwd_ms']:.3f} ms")
    log(f"  connected_components, {hw}² ({sz.cells} cells): "
        f"{out['ccl_ms']:.3f} ms")
    log(f"  relabel matmul {out['relabel_matmul_ms']:.3f} ms vs scatter "
        f"{out['relabel_scatter_ms']:.3f} ms")
    return out


# ---------------------------------------------------------------- --four


def four_card_training(sz: Sizes, work: str, n: int = 4) -> None:
    """The Trainer's data-parallel step over a 1-D ``data`` mesh of ``n``
    cards vs the same global batch and seed on one card, in float32 at
    precision 'highest' so only the gradient psum's summation order
    differs."""
    from lstm_unet_tpu.engine.train import Trainer

    if len(jax.devices()) < n:
        raise SystemExit(f"--four needs {n} devices, JAX has "
                         f"{len(jax.devices())}")
    root = os.path.join(work, "ctc")
    write_ctc_dataset(root, num_frames=sz.dataset_frames,
                      height=sz.stream_hw, width=sz.stream_hw,
                      num_cells=sz.cells, seed=0)
    lr = 1e-5
    results = {}
    for cards in (1, n):
        p = train_params(
            sz, root_data_dir=root, dtype="float32", dry_run=True,
            learning_rate=lr,
            train_sequence_list=[("Synth-N2DH-SIM", "01")],
            mesh_shape={"data": cards}, print_to_console_interval=1,
            validation_interval=10 ** 9, write_to_tb_interval=10 ** 9)
        t0 = time.perf_counter()
        with jax.default_matmul_precision("highest"):
            trainer = Trainer(p, seed=0)
            m = trainer.train(num_iterations=1)
        results[cards] = (m["loss"], flatten_tree(trainer.model_params))
        log(f"  {cards} card(s): loss {m['loss']:.7f}, "
            f"{time.perf_counter() - t0:.1f} s incl. compile")
    (l1, p1), (ln, pn) = results[1], results[n]
    # the first Adam step moves every weight by lr * g/(|g| + eps), at most
    # lr; a psum-order difference changes that only where |g| ~ eps
    diffs = np.concatenate([np.abs(p1[k] - pn[k]).ravel() for k in p1])
    check(f"loss {n} cards vs 1", abs(ln - l1) / abs(l1), 1e-5)
    check(f"max |param diff| / lr", float(diffs.max()) / lr, 2.0)
    check(f"mean |param diff| / lr", float(diffs.mean()) / lr, 1e-3)


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the data-parallel training path on four "
                         "cards and its one-card comparison")
    args = ap.parse_args(argv)
    enable_compile_cache()
    t_start = time.perf_counter()
    dev = phase0_card()
    gpu = bench.gpu_name_and_power_limit()
    sz = FLAGSHIP
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four:
            log("four cards: data-parallel Trainer vs one card")
            four_card_training(sz, work)
        else:
            phase1_compile(sz)
            log(f"  (phase1 done at {time.perf_counter() - t_start:.0f} s)")
            # the CPU reference runs beside phases 2-3 (XLA:CPU releases
            # the GIL); its result is read, and any error raised, in phase 3
            with ThreadPoolExecutor(max_workers=1) as pool:
                cpu_logits = pool.submit(cpu_reference_logits, sz)
                phase2_main_path(sz, work, gpu)
                log(f"  (phase2 done at {time.perf_counter() - t_start:.0f} "
                    "s)")
                phase3_correctness(sz, cpu_logits.result(), gpu)
            log(f"  (phase3 done at {time.perf_counter() - t_start:.0f} s)")
            phase4_kernels(sz, gpu)
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.0f} s on {gpu}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
