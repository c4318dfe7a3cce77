"""Streaming inference engine.

Reference parity: ``Inference2D.py`` (SURVEY.md §2 "Inference driver", §3.2):
rebuild the model from the saved architecture file, restore the checkpoint,
reflect-pad each frame to a multiple of 2^depth, stream frames one at a time
with LSTM state carried across the whole sequence (never reset), per frame
softmax → threshold → connected components → min-size filter → boundary
growth → FOV rule → ``mask###.tif`` uint16, optional intermediate softmax
dumps.

Deltas from the reference (its biggest perf sink was a GPU→CPU sync +
OpenCV pass per frame — SURVEY.md §3.2 note):
- model step + softmax + full instance postprocess are ONE jitted device
  function per frame; only the final int32 label map crosses to the host
- the state pytree is donated → zero-copy streaming, O(1) in sequence length
- TIFF encoding runs on a writer thread, overlapped with the next frame
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..checkpoint import CheckpointManager, load_model_params, resolve_model_dir
from ..config import CTCInferenceParams, NetKernelParams
from ..io.dataset import CTCInferenceReader
from ..io.preprocess import pad_to_multiple
from ..io.tiff import write_tiff
from ..models import ModelConfig, ULSTMnet2D
from ..ops.postprocess import postprocess_frame
from ..utils import log_print


def load_model(model_path: str, dtype: Optional[str] = None,
               state_dtype: Optional[str] = None,
               step: Optional[int] = None) -> Tuple[Any, ModelConfig]:
    """Rebuild model from model_params.json + a step checkpoint (reference:
    pickled arch + tf Checkpoint.restore [M]). Accepts a model dir or the training
    run dir nesting it under ckpt/ (resolve_model_dir)."""
    model_path = resolve_model_dir(model_path)
    arch = load_model_params(model_path)
    cfg_kw = dict(arch["model_config"])
    if dtype == "int8":  # int8 convs, bf16 elsewhere (ops/quant.py)
        cfg_kw["dtype"] = "bfloat16"
        cfg_kw["quant"] = "int8"
    elif dtype is not None:
        cfg_kw["dtype"] = dtype
    if state_dtype is not None:
        cfg_kw["state_dtype"] = state_dtype
    cfg = ModelConfig(**cfg_kw)
    # init abstractly to get the param tree structure, then restore real values
    abstract = jax.eval_shape(
        lambda: ULSTMnet2D.init(jax.random.PRNGKey(0), cfg))
    mgr = CheckpointManager(model_path)
    params = mgr.restore_params_only(abstract, step=step)
    return params, cfg


ACT_SCALES_FILE = "act_scales.json"


def calibrate_act_scales(params, cfg: ModelConfig, frames: List[np.ndarray],
                         ) -> Dict[str, float]:
    """Per-conv-site activation absmax over calibration frames (int8 path).

    Runs the FLOAT model (quant disabled, same topology/split settings)
    statefully over ``frames`` (raw [H,W], percentile-normalized here the
    same way the streaming step normalizes) and returns the running max of
    every conv input site — the static scales that replace the per-frame
    dynamic abs-max reduction in ops/quant.py. One-time cost; persist with
    ``save_act_scales`` next to the checkpoint.
    """
    from ..io.preprocess import percentile_normalize_np
    from ..models.ulstm_unet import cast_params_for_inference

    fcfg = dataclasses.replace(cfg, quant="none")

    @jax.jit
    def cstep(params, state, frame):
        collect: Dict[str, jax.Array] = {}
        new_state, _ = ULSTMnet2D.step(params, state, frame, fcfg,
                                       collect_scales=collect)
        return new_state, collect

    h, w = frames[0].shape
    mult = 2 ** cfg.nkp.depth
    params_dev = jax.device_put(
        cast_params_for_inference(params, fcfg.compute_dtype))
    state = ULSTMnet2D.init_state(fcfg, 1, h + (-h) % mult, w + (-w) % mult)
    running: Dict[str, float] = {}
    for f in frames:
        x, _ = pad_to_multiple(percentile_normalize_np(f), mult)
        state, collected = cstep(params_dev, state,
                                 jnp.asarray(x, jnp.float32)[None, ..., None])
        for k, v in collected.items():
            running[k] = max(running.get(k, 0.0), float(v))
    return running


def _scales_provenance(model_path: str,
                       step: Optional[int] = None) -> Dict[str, Any]:
    """Identity of the weights act_scales were calibrated against: the
    checkpoint step the weights came from (``step``; default = latest
    step-numbered subdir) + sha256 of the arch file. Guards against silently
    pairing stale static scales with new weights after recalibration/ckpt
    swaps/dir copies (VERDICT r2 weak #6)."""
    import hashlib

    from ..checkpoint.ckpt import MODEL_PARAMS_FILE

    prov: Dict[str, Any] = {}
    arch_path = os.path.join(model_path, MODEL_PARAMS_FILE)
    if os.path.exists(arch_path):
        with open(arch_path, "rb") as f:
            prov["arch_sha256"] = hashlib.sha256(f.read()).hexdigest()
    if step is not None:
        prov["ckpt_step"] = step
        return prov
    steps = [int(d) for d in os.listdir(model_path)
             if d.isdigit() and os.path.isdir(os.path.join(model_path, d))]
    if steps:
        prov["ckpt_step"] = max(steps)
    return prov


def save_act_scales(model_path: str, scales: Dict[str, float],
                    step: Optional[int] = None) -> str:
    model_path = resolve_model_dir(model_path)
    path = os.path.join(model_path, ACT_SCALES_FILE)
    out = dict(scales)
    out["__provenance__"] = _scales_provenance(model_path, step)
    with open(path, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
    return path


def load_act_scales(model_path: str,
                    step: Optional[int] = None) -> Optional[Dict[str, float]]:
    """Load calibrated scales, verifying provenance. On a stale stamp
    (checkpoint advanced or architecture changed since calibration, or the
    run restores a different ``step`` than the scales were calibrated at)
    warns loudly and returns None — the int8 path then falls back to
    per-frame dynamic scales, which are always weight-consistent."""
    model_path = resolve_model_dir(model_path)
    path = os.path.join(model_path, ACT_SCALES_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        scales = json.load(f)
    stamped = scales.pop("__provenance__", None)
    if stamped is None:
        log_print(f"WARNING: {path} has no provenance stamp (pre-r3 file); "
                  "cannot verify the scales match the checkpoint — "
                  "re-calibrate to silence this")
        return scales
    current = _scales_provenance(model_path, step)
    if stamped != current:
        log_print(f"WARNING: {path} is STALE (calibrated at {stamped}, "
                  f"model dir now {current}) — ignoring static scales, "
                  "falling back to dynamic int8 scales; re-run calibration")
        return None
    return scales


def calibrate_model_dir(model_path: str, sequence_path: str,
                        n_frames: int = 8,
                        filename_format: str = "t*.tif",
                        step: Optional[int] = None) -> str:
    """One-shot calibration: first ``n_frames`` of a sequence -> act_scales.json
    in the model dir (picked up automatically by every later int8 run)."""
    params, cfg = load_model(model_path, step=step)  # float, as trained
    reader = CTCInferenceReader(sequence_path, filename_format,
                                pre_sequence_frames=0, normalize=False)
    frames = []
    for _, frame in reader:
        frames.append(frame)
        if len(frames) >= n_frames:
            break
    scales = calibrate_act_scales(params, cfg, frames)
    path = save_act_scales(model_path, scales, step=step)
    log_print(f"calibrated {len(scales)} activation sites over "
              f"{len(frames)} frames -> {path}")
    return path


class StreamingInferenceEngine:
    """Stateful O(1)-memory streaming over arbitrarily long sequences.

    With ``ip.mesh_shape`` set (e.g. {'data': 2, 'spatial': 4}) the stream
    runs SPMD: batched sequences shard over 'data', frame height over
    'spatial' (XLA SPMD inserts the conv halo exchanges). The
    LSTM state inherits the same sharding and never leaves its shard.
    """

    def __init__(self, params, cfg: ModelConfig, ip: CTCInferenceParams):
        self.params = params
        self.cfg = cfg
        self.ip = ip
        if getattr(ip, "conv_method", "conv") != "conv":
            from ..ops.conv import set_conv_method

            set_conv_method(ip.conv_method)
        self.depth_multiple = 2 ** cfg.nkp.depth
        self._step = None
        self._state = None
        self._shape = None
        # calibrated int8 activation scales, when saved next to the ckpt
        self._act_scales = (
            load_act_scales(ip.model_path,
                            step=getattr(ip, "ckpt_step", 0) or None)
            if cfg.quant == "int8" and ip.model_path else None)
        self.mesh = None
        if getattr(ip, "mesh_shape", None):
            from ..parallel import make_mesh

            self.mesh = make_mesh(ip.mesh_shape)

    def _padded_hw(self, oh: int, ow: int) -> Tuple[int, int]:
        """Device frame shape for an original (oh, ow): multiple of
        2^depth, and SQUARE under tta_mode='d4' (the transposed variants
        must share the batch shape)."""
        h = oh + (-oh) % self.depth_multiple
        w = ow + (-ow) % self.depth_multiple
        if (bool(getattr(self.ip, "tta", False))
                and str(getattr(self.ip, "tta_mode", "flip") or "flip")
                == "d4"):
            h = w = max(h, w)
        return h, w

    def _pad_frame(self, frame: np.ndarray) -> np.ndarray:
        """Host-side reflect pad of [..., H, W] up to ``_padded_hw``.
        Chunked reflect (np.pad caps each reflect at size-1) so extreme
        aspect ratios still square-pad under d4."""
        oh, ow = frame.shape[-2], frame.shape[-1]
        th, tw = self._padded_hw(oh, ow)
        ph, pw = th - oh, tw - ow
        while ph > 0 or pw > 0:
            dh = min(ph, frame.shape[-2] - 1)
            dw = min(pw, frame.shape[-1] - 1)
            pad = [(0, 0)] * (frame.ndim - 2) + [(0, dh), (0, dw)]
            frame = np.pad(frame, pad, mode="reflect")
            ph -= dh
            pw -= dw
        return frame

    def _shard(self, tree, spec):
        if self.mesh is None:
            return tree
        from jax.sharding import NamedSharding

        sh = NamedSharding(self.mesh, spec)
        return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)

    def _cast_params(self, params):
        if self.cfg.quant == "int8":
            from ..ops.quant import quantize_params_int8

            return quantize_params_int8(
                params, self._act_scales,
                keep_float=getattr(self.ip, "int8_keep_float", None),
                float_dtype=self.cfg.compute_dtype)
        from ..models.ulstm_unet import cast_params_for_inference

        return cast_params_for_inference(params, self.cfg.compute_dtype)

    def _build(self, oh: int, ow: int, batch: int = 1):
        """Compile the per-frame step for ORIGINAL frame size (oh, ow).

        The model consumes the reflect-padded frame (multiple of 2^depth)
        but normalization statistics and the instance postprocess run at
        the original size: reflected duplicate pixels would shift the
        percentiles vs training's pre-crop normalization, inflate border
        cells for the size filters, and move the FOV border (reference
        postprocesses at original size — ADVICE r1 / VERDICT r1 weak #7).
        """
        ip = self.ip
        # test-time augmentation: the variants stream as extra batch lanes
        # (ONE jitted step at batch*n_var, each variant carrying its own
        # LSTM state), probs aligned back + averaged before postprocess.
        # n_var x model compute for a quality bump — off by default; no
        # reference analog. Transforms of the PADDED frame move the reflect
        # padding to other borders, which is just another augmented view —
        # inverse-transforming the logits restores alignment, then the
        # interior crop is taken as usual. 'flip' = 4 axis flips; 'd4'
        # adds the 4 transposed variants (frames pad to a SQUARE).
        tta = bool(getattr(ip, "tta", False))
        tta_mode = str(getattr(ip, "tta_mode", "flip") or "flip")
        n_var = (8 if tta_mode == "d4" else 4) if tta else 1
        h, w = self._padded_hw(oh, ow)  # square under d4
        # reset_on_jump: carry the previous normalized frame and zero a
        # lane's LSTM state when the scene changes abruptly (BASELINE.md
        # carry-drift stress: discontinuities saturate the carried state in
        # ANY precision; the reference never resets — off by default)
        jump_thresh = float(getattr(ip, "reset_on_jump", 0.0) or 0.0)

        # params is an explicit jit argument (closed-over arrays would be
        # inlined into the HLO as constants — huge programs, slow compiles)
        @functools.partial(jax.jit, donate_argnums=(1,))
        def step(params, carry, frame):
            state, prev = carry if jump_thresh > 0 else (carry, None)
            # percentile normalization on device: the reference normalizes
            # per frame on the host (SURVEY.md §2 "Inference reader") which
            # on a thin host would bottleneck the streaming loop.
            # Stats come from the unpadded interior only (crop is static).
            # Integer frames (raw CTC uint8/uint16) take the exact
            # histogram quantile — no 512²-sort, and the half-width
            # upload; float frames keep the sort (histogram quantiles are
            # only exact on the integer domain).
            def norm(f):  # [H,W,1] padded
                if jnp.issubdtype(f.dtype, jnp.integer):
                    from ..io.preprocess import integer_percentile_bounds

                    lo, hi = integer_percentile_bounds(f[:oh, :ow], 1.0, 99.0)
                else:
                    inner = f[:oh, :ow].astype(jnp.float32).reshape(-1)
                    lo, hi = jnp.percentile(inner, jnp.array([1.0, 99.0]))
                return (f.astype(jnp.float32) - lo) / jnp.maximum(hi - lo, 1e-6)

            frame = jax.vmap(norm)(frame)
            if jump_thresh > 0:
                # per-lane mean abs delta of the normalized frames, CLIPPED
                # to the nominal [0,1] range first: low-contrast (no-signal)
                # frames amplify noise through the percentile divide, and
                # clipping bounds their delta to ~0.5 instead of arbitrary
                # magnitude — blank gaps still read as cuts (intended: a
                # blank stretch IS a scene cut) but thresholds stay
                # meaningful. prev starts NaN -> the comparison is False on
                # the first frame (no reset).
                a = jnp.clip(frame, 0.0, 1.0)
                b = jnp.clip(prev, 0.0, 1.0)
                jumps = jnp.mean(jnp.abs(a - b), axis=(1, 2, 3))
                reset_mask = (jumps > jump_thresh).astype(jnp.float32)
                if tta:  # state lanes are [B*4]; same cut for every variant
                    reset_mask = jnp.tile(reset_mask, n_var)
                state = ULSTMnet2D.reset_lanes(state, reset_mask)
            if tta:
                # variant-major stacking [v0 lanes..., v1 lanes, ...] so a
                # plain tile covers the reset mask above
                variants = [frame, frame[:, ::-1], frame[:, :, ::-1],
                            frame[:, ::-1, ::-1]]
                if n_var == 8:  # + the transposed half of the D4 group
                    ft = jnp.swapaxes(frame, 1, 2)
                    variants += [ft, ft[:, ::-1], ft[:, :, ::-1],
                                 ft[:, ::-1, ::-1]]
                xin = jnp.concatenate(variants, axis=0)
            else:
                xin = frame
            new_state, logits = ULSTMnet2D.step(params, state, xin, self.cfg)
            if jump_thresh > 0:
                new_state = (new_state, frame)
            if tta:
                lv = logits.reshape((n_var, frame.shape[0]) + logits.shape[1:])
                aligned = [lv[0], lv[1, :, ::-1], lv[2, :, :, ::-1],
                           lv[3, :, ::-1, ::-1]]
                if n_var == 8:
                    # invert fwd = (transpose, then flip): undo the flip,
                    # then transpose back
                    aligned += [jnp.swapaxes(lv[4], 1, 2),
                                jnp.swapaxes(lv[5, :, ::-1], 1, 2),
                                jnp.swapaxes(lv[6, :, :, ::-1], 1, 2),
                                jnp.swapaxes(lv[7, :, ::-1, ::-1], 1, 2)]
                logits_al = jnp.stack(aligned, axis=0)
                # postprocess at original size; average PROBS (not logits) —
                # the standard TTA ensemble
                probs = jax.nn.softmax(
                    logits_al[:, :, :oh, :ow], axis=-1).mean(axis=0)
            else:
                probs = jax.nn.softmax(logits[:, :oh, :ow], axis=-1)
            labels = jax.vmap(
                lambda p: postprocess_frame(
                    p,
                    cell_thresh=ip.cell_thresh,
                    edge_thresh=ip.edge_thresh,
                    min_cell_size=ip.min_cell_size,
                    max_cell_size=ip.max_cell_size,
                    size_filter=getattr(ip, "size_filter", "pre"),
                    fov=ip.FOV,
                    boundary_growth=ip.boundary_growth,
                    grow_iters=ip.grow_iters,
                    instance_split=getattr(ip, "instance_split", False),
                    split_method=getattr(ip, "split_method", "dist"),
                    split_window=getattr(ip, "split_window", 16),
                    split_min_dist=getattr(ip, "split_min_dist", 4),
                    split_slack=getattr(ip, "split_slack", 1),
                    split_rel=getattr(ip, "split_rel", 0.65),
                    split_rel_window=getattr(ip, "split_rel_window", 48),
                    split_min_size=getattr(ip, "split_min_size", 0),
                    split_hi_thresh=getattr(ip, "split_hi_thresh", 0.8),
                    split_erode=getattr(ip, "split_erode", 1),
                )
            )(probs)
            if not ip.save_intermediate:
                # don't ship the [B,H,W,3] float probs to the host each frame
                # — only the int32 label map crosses (module contract)
                probs = jnp.zeros((0,), jnp.float32)
            return new_state, labels, probs

        if self.mesh is not None:
            from jax.sharding import PartitionSpec as P

            # build the [B, H, ...] spec from the axes the mesh actually has,
            # and only shard a dim when it divides evenly: batch over 'data',
            # and EVERY state level's height (h / 2^l) over 'spatial' —
            # device_put of unevenly-sharded explicit state would crash
            shape = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
            data_n = shape.get("data", 0)
            spatial_n = shape.get("spatial", 0)
            data_ok = data_n > 1 and batch % data_n == 0
            if tta and data_ok:
                # the model batch is batch*4 variant-major; the INPUT frame
                # batch is still `batch`, and XLA would reshard across the
                # in-jit concat — keep the batch dim replicated under TTA
                log_print("mesh: tta active — replicating the batch dim")
                data_ok = False
            spatial_ok = (spatial_n > 1
                          and h % (spatial_n * 2 ** self.cfg.nkp.depth) == 0)
            if data_n > 1 and not data_ok:
                log_print(f"mesh: batch={batch} not divisible by data={data_n}"
                          " — replicating the batch dim")
            if spatial_n > 1 and not spatial_ok:
                log_print(f"mesh: H={h} not divisible by spatial={spatial_n}"
                          f"*2^{self.cfg.nkp.depth} — replicating the H dim")
        state = ULSTMnet2D.init_state(self.cfg, batch * n_var, h, w)
        if jump_thresh > 0:
            state = (state, jnp.full((batch, h, w, 1), jnp.nan, jnp.float32))
        if self.mesh is not None:
            spec = P("data" if data_ok else None,
                     "spatial" if spatial_ok else None)
            params_dev = self._shard(self._cast_params(self.params), P())
            state = self._shard(state, spec)
            self._frame_spec = spec
        else:
            params_host = self._cast_params(self.params)
            self._frame_spec = None
            if getattr(ip, "entry_layouts", False):
                # weights are device_put into the executable's preferred
                # formats inside the AOT wrapper — skip the default-layout
                # upload entirely
                self._params_dev = None
                self._step = self._make_auto_layout_step(step, params_host)
                self._state = state
                self._shape = (batch, oh, ow)
                return
            params_dev = jax.device_put(params_host)
        self._params_dev = params_dev
        self._step = lambda s, frame: step(self._params_dev, s, frame)
        self._state = state
        self._shape = (batch, oh, ow)

    def _make_auto_layout_step(self, step, params_host):
        """AOT-compile ``step`` with AUTO entry layouts for the params.

        jit entry parameters are pinned to JAX's default (descending-major)
        layouts, so XLA layout assignment inserts copies INSIDE the program
        to re-lay-out every conv kernel into its blocked conv layout — paid
        every frame. ``Layout.AUTO`` lets layout assignment choose the entry
        layouts instead; the weights are ``device_put`` into the compiled
        executable's preferred formats ONCE and the per-frame copies fall
        out of the program. State and frame keep default layouts: the
        donated state output must feed the next call's input, and AUTO
        gives no in==out guarantee. Compiled lazily per frame signature
        (the upload dtype — raw uint16 vs float32 — is only known at the
        first frame). Single-device only; measured A/B knob.
        """
        from jax.experimental.layout import Format, Layout

        cache: dict = {}

        def sds(x):
            return jax.ShapeDtypeStruct(x.shape, x.dtype)

        def run(state, frame):
            key = (frame.shape, str(frame.dtype))
            ent = cache.get(key)
            if ent is None:
                jitted = jax.jit(step, donate_argnums=(1,),
                                 in_shardings=(Format(Layout.AUTO),
                                               None, None))
                t0 = time.time()
                comp = jitted.lower(
                    jax.tree_util.tree_map(sds, params_host),
                    jax.tree_util.tree_map(sds, state),
                    sds(frame)).compile()
                pdev = jax.device_put(params_host, comp.input_formats[0][0])
                log_print(f"entry_layouts: AOT-compiled {key} in "
                          f"{time.time() - t0:.1f}s; weights re-laid-out")
                ent = cache[key] = (comp, pdev)
            comp, pdev = ent
            return comp(pdev, state, frame)

        return run

    def reset(self):
        self._state = None
        self._shape = None

    def step_async(self, frame: np.ndarray):
        """Dispatch one frame [H,W] float32; return DEVICE (labels, probs).

        Returns immediately after async dispatch — materializing the
        outputs (np.asarray) is the caller's job. The streaming drivers
        materialize one frame BEHIND the dispatch so the host-side label
        download and the next frame's upload overlap device compute
        (software pipelining; VERDICT r2 weak #8)."""
        h, w = frame.shape
        padded = self._pad_frame(frame)
        if self._shape != (1, h, w):
            self._build(h, w)
        # integer frames upload raw (half the bytes of f32) and normalize
        # via the exact on-device histogram quantile
        x = jnp.asarray(padded)[None, ..., None]
        if not jnp.issubdtype(x.dtype, jnp.integer):
            x = x.astype(jnp.float32)
        if self._frame_spec is not None:
            x = self._shard(x, self._frame_spec)
        self._state, labels, probs = self._step(self._state, x)
        return labels, probs

    def process_frame(self, frame: np.ndarray):
        """One frame [H,W] float32 → (labels [H,W] int32, probs [H,W,3]|None).

        Pads to 2^depth internally and crops the outputs back. ``probs`` is
        None unless ``ip.save_intermediate`` — the hot loop only ships the
        int32 label map to the host. Synchronous convenience wrapper over
        :meth:`step_async`.
        """
        labels, probs = self.step_async(frame)
        probs_out = (np.asarray(probs[0])
                     if self.ip.save_intermediate else None)
        return np.asarray(labels[0]), probs_out


class _Prefetcher:
    """Background TIFF decode: overlap host io with device compute.

    Reader exceptions (e.g. a corrupt TIFF mid-sequence) propagate to the
    consumer instead of silently truncating the stream.
    """

    _END = object()

    def __init__(self, iterable, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, args=(iterable,),
                                   daemon=True)
        self._t.start()

    def _loop(self, iterable):
        try:
            for item in iterable:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # re-raised on the consumer side
            self._err = e
        finally:
            # the END sentinel must reach the consumer even when the queue is
            # momentarily full; only a close() may abandon the attempt
            while True:
                try:
                    self._q.put(self._END, timeout=0.2)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        break

    def close(self):
        """Stop the decode thread early (abandoned streams don't keep
        decoding frames into a blocked queue)."""
        self._stop.set()
        self._t.join(timeout=2.0)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._END:
                if self._err is not None:
                    raise self._err
                return
            yield item


class _AsyncWriter:
    """Writer thread: overlap host TIFF encode with device compute.

    Fail-fast: the FIRST write error is kept and re-raised on the next
    ``put()`` (and again on ``close()`` if never surfaced) — a failing disk
    stops the stream within ~one frame instead of silently burning device
    time producing masks that will be reported failed at the end.
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue(maxsize=8)
        self._err = None  # first error wins
        self._raised = False
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is not None:
                continue  # error pending: drain without writing
            path, arr = item
            try:
                write_tiff(path, arr)
            except Exception as e:
                self._err = e

    def put(self, path: str, arr: np.ndarray):
        if self._err is not None:
            self._raised = True
            raise self._err
        self._q.put((path, arr))

    def close(self):
        self._q.put(None)
        self._t.join()
        if self._err and not self._raised:
            self._raised = True
            raise self._err


def _arm_watchdog(ip: CTCInferenceParams, label: str):
    """Arm a StallWatchdog when ``ip.watchdog_secs`` > 0 (else None).

    Same failure detector as the Trainer's (utils/watchdog.py): a wedged
    device client parks every thread; only a process exit frees the card.
    """
    secs = float(getattr(ip, "watchdog_secs", 0.0) or 0.0)
    if secs <= 0:
        return None
    from ..utils.watchdog import StallWatchdog

    # 3x grace before the first frame: the first step's compile can
    # legitimately exceed the per-frame timeout
    return StallWatchdog(timeout_s=secs, label=label,
                         first_timeout_s=3.0 * secs).start()


def run_inference_batched(ip: CTCInferenceParams, sequence_paths, output_paths,
                          params=None, cfg: Optional[ModelConfig] = None) -> int:
    """Batched multi-sequence streaming inference (BASELINE.json config #5).

    All sequences must share one frame shape (the CTC sweep driver groups by
    shape). Lanes whose sequence is exhausted keep streaming their last frame
    (static shapes under jit) but outputs are discarded. One jitted device
    program per frame-step serves the whole batch; LSTM state stays per-lane.
    No reference analog — Inference2D.py is strictly one-sequence-at-a-time;
    this is the batched upgrade of that driver.

    Ragged ends: an exhausted lane wastes ~1/B of the device, but re-jitting
    at a smaller B costs a full compile, so lanes stay at B; the sweep
    driver minimizes the tail by batching length-sorted sequences
    (ROADMAP R1 replaces this with lane refill).
    """
    if params is None or cfg is None:
        params, cfg = load_model(ip.model_path, dtype=ip.dtype,
                                 state_dtype=getattr(ip, "state_dtype", None),
                                 step=getattr(ip, "ckpt_step", 0) or None)
    engine = StreamingInferenceEngine(params, cfg, ip)
    readers = [
        CTCInferenceReader(sp, ip.filename_format, ip.pre_sequence_frames,
                           normalize=False)
        for sp in sequence_paths
    ]
    prefetchers = [_Prefetcher(r, depth=2) for r in readers]
    iters = [iter(p) for p in prefetchers]
    fmt = "mask%04d.tif" if ip.digit_4 else "mask%03d.tif"
    n = 0
    b = len(readers)
    writer = None
    # stall watchdog: armed over compile + stream, fed per frame-step; a
    # wedged device client hard-exits 17 so a supervisor can rerun the
    # stage instead of hanging to its timeout
    wd = _arm_watchdog(ip, "infer-batched")
    try:
        cur = [next(it) for it in iters]  # (idx, frame) per lane
        done = [False] * b
        raw_shapes = [f.shape for _, f in cur]  # per-lane crop-back shapes
        if len(set(raw_shapes)) != 1:
            raise ValueError(
                f"batched inference requires equal frame shapes, got {raw_shapes}")
        engine._build(*raw_shapes[0], batch=b)
        writer = _AsyncWriter()

        def emit(writes, labels_dev, probs_dev):
            nonlocal n
            labels_np = np.asarray(labels_dev)
            probs_np = (np.asarray(probs_dev)
                        if ip.save_intermediate else None)
            for lane, idx in writes:
                h, w = raw_shapes[lane]
                lane_labels = labels_np[lane, :h, :w]
                # overflow check per SURVIVING lane only: an exhausted lane
                # keeps stepping (static shapes) and its discarded output
                # may legitimately poison (>65535 ids) without aborting the
                # live lanes' stream (VERDICT r2 weak #7)
                if lane_labels.max() > np.iinfo(np.uint16).max:
                    raise ValueError(
                        f"instance count exceeds uint16 (lane {lane})")
                writer.put(os.path.join(output_paths[lane], fmt % idx),
                           lane_labels.astype(np.uint16))
                if ip.save_intermediate:
                    # per-lane dir (a shared save_intermediate_path
                    # would collide across lanes)
                    inter = os.path.join(output_paths[lane], "intermediate")
                    os.makedirs(inter, exist_ok=True)
                    np.save(os.path.join(inter, f"probs{idx:03d}.npy"),
                            probs_np[lane, :h, :w])
                n += 1

        # software pipeline (same as run_inference): dispatch batch t, then
        # materialize batch t-1 — downloads/uploads overlap device compute
        pending = None  # (writes, labels_dev, probs_dev)
        while not all(done):
            if wd is not None:
                wd.feed()
            for lane, (_, f) in enumerate(cur):
                if f.shape != raw_shapes[lane]:
                    raise ValueError(
                        f"lane {lane} frame shape changed mid-sequence: "
                        f"{raw_shapes[lane]} -> {f.shape}")
            frames = np.stack([engine._pad_frame(f) for _, f in cur])
            x = jnp.asarray(frames)[..., None]
            if not jnp.issubdtype(x.dtype, jnp.integer):
                x = x.astype(jnp.float32)
            if engine._frame_spec is not None:
                x = engine._shard(x, engine._frame_spec)
            engine._state, labels, probs = engine._step(engine._state, x)
            writes = [(lane, cur[lane][0]) for lane in range(b)
                      if cur[lane][0] is not None and not done[lane]]
            if pending is not None:
                emit(*pending)
            pending = (writes, labels, probs)
            for lane in range(b):
                if done[lane]:
                    continue
                try:
                    cur[lane] = next(iters[lane])
                except StopIteration:
                    done[lane] = True
        if pending is not None:
            emit(*pending)
    finally:
        if wd is not None:
            wd.stop()
        if writer is not None:
            writer.close()
        for p in prefetchers:
            p.close()
    log_print(f"batched inference: wrote {n} masks across {b} sequences")
    return n


def run_inference(ip: CTCInferenceParams) -> int:
    """Full inference driver; returns number of masks written.

    Output contract (SURVEY.md §8.4): per frame a uint16 instance-labeled
    ``mask###.tif`` under ``output_path``; optional intermediate 3-class
    probability maps when ``save_intermediate``.
    """
    params, cfg = load_model(ip.model_path, dtype=ip.dtype,
                             state_dtype=getattr(ip, "state_dtype", None),
                             step=getattr(ip, "ckpt_step", 0) or None)
    engine = StreamingInferenceEngine(params, cfg, ip)
    # raw frames: normalization runs on device inside the jitted step;
    # decode happens on a prefetch thread, overlapped with device compute
    reader = CTCInferenceReader(ip.sequence_path, ip.filename_format,
                                ip.pre_sequence_frames, normalize=False)
    writer = _AsyncWriter()
    prefetcher = _Prefetcher(reader)
    fmt = "mask%04d.tif" if ip.digit_4 else "mask%03d.tif"
    n = 0

    def emit(idx, labels_dev, probs_dev):
        labels = np.asarray(labels_dev[0])
        if labels.max() > np.iinfo(np.uint16).max:
            raise ValueError("instance count exceeds uint16")
        writer.put(os.path.join(ip.output_path, fmt % idx),
                   labels.astype(np.uint16))
        if ip.save_intermediate:
            inter_dir = ip.save_intermediate_path or os.path.join(
                ip.output_path, "intermediate")
            os.makedirs(inter_dir, exist_ok=True)
            np.save(os.path.join(inter_dir, f"probs{idx:03d}.npy"),
                    np.asarray(probs_dev[0]))

    # software-pipelined stream: dispatch frame t, then materialize frame
    # t-1's outputs — the label download and frame-(t+1) upload overlap
    # frame t's device compute instead of serializing with it
    pending = None  # (idx, labels_dev, probs_dev)
    wd = _arm_watchdog(ip, "infer")
    try:
        for idx, frame in prefetcher:
            if wd is not None:
                wd.feed()
            labels_dev, probs_dev = engine.step_async(frame)
            if pending is not None:
                emit(*pending)
                n += 1
            # warm-up frames (idx None): state kept, output discarded
            pending = (idx, labels_dev, probs_dev) if idx is not None else None
        if pending is not None:
            emit(*pending)
            n += 1
    finally:
        if wd is not None:
            wd.stop()
        writer.close()
        prefetcher.close()
    log_print(f"inference: wrote {n} masks to {ip.output_path}")
    return n
