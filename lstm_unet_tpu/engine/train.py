"""Training engine.

Reference parity: ``train2D.py`` (SURVEY.md §2 "Train driver", §3.1):
argparse→params, readers, model, Adam, a compiled train step doing forward
over the unroll window + weighted CE + gradient update, LSTM state carried
across steps with per-lane reset at sequence ends, periodic validation with
its own state, TensorBoard scalars, checkpoints + architecture file,
optional profiler trace, ``dry_run`` skipping writes.

Shape of the rebuild: the step is one jitted function with donated
params/opt_state/lstm_state (zero-copy across steps); truncated BPTT falls
out of the scan window — the carried state is a fresh input each step, so
gradients stop at window boundaries exactly like the reference's
``tf.function`` step (SURVEY.md §8.3). Data-parallel runs shard the batch
over the 'data' mesh axis; XLA inserts the gradient psum.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..checkpoint import CheckpointManager, save_model_params
from ..config import CTCParams
from ..io.dataset import CTCRAMReaderSequence2D
from ..models import ModelConfig, ULSTMnet2D
from ..parallel import (make_mesh, mesh_axis_sizes, replicated_sharding,
                        shard_batch, shard_state)
from ..utils import log_print
from ..utils.watchdog import STALL_EXIT_CODE, rss_gb

_RSS_CHECK_EVERY = 50  # steps between host-RSS guard checks (~µs each)
from .loss import weighted_ce_loss

from ..io.grain_reader import GrainCTCReaderSequence2D

# data-provider registry (reference: Params.data_provider_class names the
# reader class to instantiate [M]); extendable by downstream users
DATA_PROVIDERS = {
    "CTCRAMReaderSequence2D": CTCRAMReaderSequence2D,
    # deterministic grain pipeline: batch(step) is a pure function of
    # (seed, step) — resumable mid-stream on continue_run
    "GrainCTCReaderSequence2D": GrainCTCReaderSequence2D,
}


def make_train_step(cfg: ModelConfig, optimizer: optax.GradientTransformation,
                    class_weights, remat: bool | str = False,
                    entry_layouts: bool = False):
    """Build the jitted train step.

    (params, opt_state, lstm_state, img, seg, valid, full_seg, is_last)
      -> (params, opt_state, lstm_state, metrics)
    State is donated: streaming BPTT never copies the carry through HBM.

    ``entry_layouts``: AOT-compile with AUTO entry/exit layouts for the
    cycled operands (params, opt_state, lstm_state) so XLA layout
    assignment chooses them instead of pinning JAX's defaults, which can
    cost in-program re-layouts of every conv kernel per step. Safe only when the chosen exit formats equal the
    entry formats (the operands cycle through the step); on mismatch the
    plain jit path is used with a loud log line. A/B knob, default off.
    """

    def step(params, opt_state, lstm_state, img, seg, valid, full_seg, is_last):
        def loss_fn(p):
            new_state, logits = ULSTMnet2D.apply(p, lstm_state, img, cfg, remat=remat)
            loss, acc = weighted_ce_loss(logits, seg, valid, tuple(class_weights),
                                         full_seg)
            return loss, (new_state, acc)

        (loss, (new_state, acc)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        # truncate BPTT + reset finished lanes (reference:
        # reset_states_per_batch(is_last) after each step [M])
        new_state = jax.lax.stop_gradient(
            ULSTMnet2D.reset_lanes(new_state, is_last))
        gnorm = optax.global_norm(grads)
        return params, opt_state, new_state, {
            "loss": loss, "accuracy": acc, "grad_norm": gnorm}

    jitted = jax.jit(step, donate_argnums=(0, 1, 2))
    if not entry_layouts:
        return jitted
    return _auto_layout_train_step(step, jitted)


def _auto_layout_train_step(step, fallback):
    """Lazily AOT-compile ``step`` with AUTO layouts on the cycled operands.

    Compiled on the first call from the concrete avals; the three cycled
    operands are ``device_put`` into the executable's chosen entry formats
    once, and every later call passes the previous call's outputs straight
    back in (exit formats verified == entry formats at compile time).
    """
    from jax.experimental.layout import Format, Layout

    cache: dict = {}

    def sds(x):
        return jax.ShapeDtypeStruct(x.shape, x.dtype)

    def run(params, opt_state, lstm_state, *batch):
        key = tuple((b.shape, str(b.dtype)) for b in batch)
        ent = cache.get(key)
        if ent is None:
            auto = Format(Layout.AUTO)
            jitted = jax.jit(
                step, donate_argnums=(0, 1, 2),
                in_shardings=(auto, auto, auto) + (None,) * len(batch),
                out_shardings=(auto, auto, auto, None))
            comp = jitted.lower(
                *jax.tree_util.tree_map(sds, (params, opt_state, lstm_state)),
                *(sds(b) for b in batch)).compile()
            infmt = comp.input_formats[0][:3]
            outfmt = tuple(comp.output_formats[:3])
            cycle_ok = (jax.tree_util.tree_map(str, infmt)
                        == jax.tree_util.tree_map(str, outfmt))
            if not cycle_ok:
                log_print("entry_layouts: exit formats differ from entry "
                          "formats for the cycled operands — falling back "
                          "to default layouts (no per-step benefit)")
                cache[key] = (None, None)
            else:
                cache[key] = (comp, infmt)
            ent = cache[key]
        comp, infmt = ent
        if comp is None:
            return fallback(params, opt_state, lstm_state, *batch)
        params, opt_state, lstm_state = (
            jax.device_put((params, opt_state, lstm_state), infmt)
            if _needs_relayout(params, infmt[0]) else
            (params, opt_state, lstm_state))
        return comp(params, opt_state, lstm_state, *batch)

    return run


def _needs_relayout(tree, fmt_tree) -> bool:
    """True when ``tree``'s on-device formats differ from ``fmt_tree``.

    Only the FIRST call pays a relayout: later calls feed the previous
    call's outputs back in, already in the executable's formats (a no-op
    device_put would still donate-copy, so skip it entirely).
    """
    leaves = jax.tree_util.tree_leaves(tree)
    fmts = jax.tree_util.tree_leaves(
        fmt_tree, is_leaf=lambda x: hasattr(x, "layout"))
    for leaf, fmt in zip(leaves, fmts):
        got = getattr(leaf, "format", None)
        if got is None or str(got) != str(fmt):
            return True
    return False


def make_optimizer(p: CTCParams) -> optax.GradientTransformation:
    """Adam with the config's first-moment dtype, global-norm clipping and
    the skip-non-finite guard (the Trainer's optimizer)."""
    mu_dtype = getattr(p, "adam_mu_dtype", "float32")
    opt = optax.adam(p.learning_rate,
                     mu_dtype=jnp.dtype(mu_dtype) if mu_dtype
                     and mu_dtype != "float32" else None)
    if p.grad_clip_norm and p.grad_clip_norm > 0:
        opt = optax.chain(optax.clip_by_global_norm(p.grad_clip_norm), opt)
    if getattr(p, "skip_nonfinite_updates", False):
        opt = optax.apply_if_finite(opt, max_consecutive_errors=10)
    return opt


def remat_arg(p: CTCParams) -> Any:
    """``ULSTMnet2D.apply``'s remat argument from the config."""
    if p.remat and getattr(p, "remat_policy", "full") != "full":
        return p.remat_policy
    return p.remat


def make_eval_step(cfg: ModelConfig, class_weights):
    def step(params, lstm_state, img, seg, valid, full_seg, is_last):
        new_state, logits = ULSTMnet2D.apply(params, lstm_state, img, cfg)
        loss, acc = weighted_ce_loss(logits, seg, valid, tuple(class_weights),
                                     full_seg)
        new_state = ULSTMnet2D.reset_lanes(new_state, is_last)
        pred = jnp.argmax(logits, axis=-1)
        # cheap pixel-level proxy (interior-class IoU on valid frames);
        # the real per-object SEG is computed by Trainer._val_seg from the
        # returned probabilities (SURVEY.md §2 "Validation metric")
        mask = valid[:, :, None, None] > 0
        p1 = (pred == 1) & mask
        g1 = (seg == 1) & mask
        inter = jnp.sum(p1 & g1)
        union = jnp.maximum(jnp.sum(p1 | g1), 1)
        seg_proxy = inter / union
        probs = jax.nn.softmax(logits, axis=-1)
        return new_state, {"loss": loss, "accuracy": acc,
                           "seg_proxy": seg_proxy}, probs

    return jax.jit(step, donate_argnums=(1,))


class Trainer:
    """End-to-end training driver (reference: train2D.py::main [M])."""

    def __init__(self, params: CTCParams, seed: int = 0):
        self.p = params
        if params.data_format != "NHWC":
            raise ValueError(
                "data_format='NHWC' only (the reference's NCHW knob "
                "existed for cuDNN)")
        if getattr(params, "conv_method", "conv") != "conv":
            from ..ops.conv import set_conv_method

            set_conv_method(params.conv_method)
        if params.experiment_save_dir is None:
            # continue_run: reuse the latest experiment dir (a fresh
            # timestamped dir would hold no ckpt and _restore would fail —
            # ADVICE r1). This also applies when a seed
            # load_checkpoint_path is set: a retry-supervisor relaunch of a
            # seeded fine-tune must resume the run's OWN progress, not
            # restart from the seed (the seed only wins while the run has
            # no checkpoint of its own — see _restore).
            resumed = (params.continue_run and params.resolve_continue_dirs())
            if resumed:
                log_print(f"continue_run: resuming {params.experiment_save_dir}")
            else:
                params.resolve_dirs()
        self.cfg = ModelConfig.make(
            params.net_kernel_params,
            in_channels=1,
            num_classes=params.num_classes,
            activation=params.activation,
            recurrent_activation=params.recurrent_activation,
            norm=params.norm,
            dtype=params.dtype,
            state_dtype=getattr(params, "state_dtype", "auto"),
        )
        self.mesh = make_mesh(params.mesh_shape) if params.mesh_shape else None
        if self.mesh is not None:
            # dp+sp training (VERDICT r2 weak #3): batch H must divide
            # spatial * 2^depth for every encoder level's state to shard;
            # otherwise the spatial axis silently replicates — say so loudly
            sn = mesh_axis_sizes(self.mesh).get("spatial", 1)
            need = sn * 2 ** self.cfg.nkp.depth
            if sn > 1 and params.crop_size[0] % need != 0:
                log_print(
                    f"mesh: crop H={params.crop_size[0]} not divisible by "
                    f"spatial={sn} * 2^depth — H replicates over 'spatial' "
                    f"(wasted chips); pick H a multiple of {need}")

        rng = jax.random.PRNGKey(seed)
        self.model_params = ULSTMnet2D.init(rng, self.cfg)
        self.optimizer = make_optimizer(params)
        self.opt_state = self.optimizer.init(self.model_params)
        self.step_fn = make_train_step(
            self.cfg, self.optimizer, params.class_weights,
            remat=remat_arg(params),
            entry_layouts=(getattr(params, "entry_layouts", False)
                           and self.mesh is None))
        self.eval_fn = make_eval_step(self.cfg, params.class_weights)
        self.global_step = 0
        self.last_val_metrics: Dict[str, float] = {}

        # data (reference: params.data_provider_class selects the reader [M])
        provider = DATA_PROVIDERS.get(params.data_provider_class)
        if provider is None:
            raise ValueError(
                f"unknown data_provider_class {params.data_provider_class!r}; "
                f"registered: {sorted(DATA_PROVIDERS)}")
        self.reader = provider(params, seed=seed)
        # val batches carry instance GT so validation can score the real
        # per-object SEG measure, not only the pixel proxy
        self.val_reader = (
            provider(params, params.val_sequence_list,
                     num_threads=1, seed=seed + 17, return_instances=True)
            if params.val_sequence_list else None)

        # bookkeeping
        self.ckpt: Optional[CheckpointManager] = None
        self.tb = None
        if not params.dry_run:
            self.ckpt = CheckpointManager(
                params.experiment_save_dir,
                max_to_keep=params.save_checkpoint_max_to_keep)
            save_model_params(params.experiment_save_dir, {
                "model_config": dataclasses.asdict(self.cfg),
                "train_params": {
                    "net_kernel_params": params.net_kernel_params.to_dict(),
                    "num_classes": params.num_classes,
                    "crop_size": list(params.crop_size),
                    "unroll_len": params.unroll_len,
                },
            })
            # full training config next to the weights (reference: params
            # pickled beside ckpts [M]; JSON here)
            params.save_json(os.path.join(
                params.experiment_save_dir, "train_params.json"))
            try:
                from tensorboardX import SummaryWriter

                self.tb = SummaryWriter(params.experiment_log_dir)
            except Exception as e:  # TB is best-effort observability
                log_print(f"tensorboard writer unavailable: {e}")

        if params.load_checkpoint or params.continue_run:
            seed = params.load_checkpoint_path
            if (seed and params.continue_run and not params.dry_run
                    and self.ckpt.latest_step() is not None):
                # seeded fine-tune resumed mid-run: the run's own latest
                # checkpoint outranks the (older) seed
                log_print(f"continue_run: in-run checkpoint outranks seed "
                          f"{seed}")
                seed = ""
            self._restore(seed)
        # Run-level TOTAL-step target, fixed at the run's FIRST launch and
        # persisted next to the checkpoints: a seeded fine-tune's budget is
        # num_iterations steps ON TOP of the seed's step count, and a
        # supervisor relaunch (--continue_run) must resume toward that SAME
        # recorded target instead of re-deriving one from num_iterations.
        # Caught live twice, in opposite directions: r3 — each relaunch
        # added a full budget (fixed by total-step semantics); r4 — a
        # fine-tune seeded at step 8000 with num_iterations=3000 was
        # watchdog-relaunched and resumed as "0 steps remain to the 3000
        # target", silently skipping its remaining 2000 steps.
        self.target_step: Optional[int] = None
        self.initial_step = 0
        self._target_path: Optional[str] = None
        if not params.dry_run and params.experiment_save_dir:
            tpath = os.path.join(params.experiment_save_dir,
                                 "target_step.json")
            self._target_path = tpath
            if os.path.exists(tpath):
                with open(tpath) as f:
                    rec = json.load(f)
                self.target_step = int(rec["target_step"])
                self.initial_step = int(rec.get("initial_step", 0))
            elif not (params.continue_run and self.ckpt is not None
                      and self.ckpt.latest_step() is not None):
                # first launch of this run (fresh or seeded); a legacy
                # resume (pre-target-file run dir) keeps target_step=None
                # and train() falls back to num_iterations-as-total
                self.initial_step = self.global_step
                self.target_step = self.global_step + params.num_iterations
                self._write_target()
        if self.mesh is not None:
            # explicit replication (the dryrun placement): params/opt_state
            # live on every mesh device so XLA's sharding propagation sees
            # replicated weights + sharded activations -> psum'd grads
            repl = replicated_sharding(self.mesh)
            self.model_params = jax.device_put(self.model_params, repl)
            self.opt_state = jax.device_put(self.opt_state, repl)

    # ------------------------------------------------------------------

    def _write_target(self) -> None:
        if self._target_path:
            with open(self._target_path, "w") as f:
                json.dump({"target_step": self.target_step,
                           "initial_step": self.initial_step}, f)

    def _restore(self, path: str) -> None:
        mgr = self.ckpt if not path else CheckpointManager(path)
        if mgr.latest_step() is None:
            # continue_run into a dir that never reached its first save
            # (e.g. the stall watchdog fired during first-step compile and
            # the supervisor relaunched) — warn loudly and train fresh
            # rather than crashing the unattended retry loop
            log_print(f"WARNING: continue_run: no checkpoint under "
                      f"{mgr.directory} — starting fresh")
            return
        abstract = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), self.model_params)
        abstract_opt = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), self.opt_state)
        self.model_params, self.opt_state, self.global_step = mgr.restore(
            abstract, abstract_opt)
        log_print(f"restored checkpoint at step {self.global_step}")

    def _rollback(self) -> None:
        """Spike-guard restore: weights + optimizer state from the run's
        last checkpoint, WITHOUT rewinding global_step or the reader — the
        deterministic input stream moves on, so the restored weights meet
        new data instead of deterministically replaying the same spike."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            log_print("spike guard: no checkpoint to roll back to — "
                      "continuing (arm save_checkpoint_iteration)")
            return
        self.ckpt.wait()  # an in-flight async save must settle first
        abstract = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
            self.model_params)
        abstract_opt = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), self.opt_state)
        self.model_params, self.opt_state, ck_step = self.ckpt.restore(
            abstract, abstract_opt)
        if self.mesh is not None:
            repl = replicated_sharding(self.mesh)
            self.model_params = jax.device_put(self.model_params, repl)
            self.opt_state = jax.device_put(self.opt_state, repl)
        log_print(f"spike guard: restored weights/opt from step {ck_step}; "
                  f"continuing at step {self.global_step}")

    def _save_checkpoint(self, final: bool = False) -> None:
        """Checkpoint without stalling the step loop on disk writes.

        The checkpoint writer must NEVER read buffers the jitted train step
        donates: the next step overwrites them. ``CheckpointManager.save``
        therefore copies params/opt_state to host memory before it returns
        (one device→host copy of the live buffers) and only the file writes
        run on its writer thread, overlapping later train steps. The final
        save, and every save with ``async_checkpoint=False``, waits for the
        write: the process may exit immediately after.
        """
        self.ckpt.save(self.global_step, self.model_params, self.opt_state)
        if final or not self.p.async_checkpoint:
            self.ckpt.wait()

    def _fresh_state(self):
        h, w = self.p.crop_size
        state = ULSTMnet2D.init_state(self.cfg, self.p.batch_size, h, w)
        if self.mesh is not None:
            # state leaves are [B, h_l, w_l, F]: dp over batch, sp over h —
            # the dryrun_multichip placement, now engine-native
            state = shard_state(self.mesh, state)
        return state

    def _put(self, batch):
        if self.p.compact_upload:
            # (img, seg, valid, full_seg, is_last): labels → int8 (values
            # {-1..2}; one_hot/compare are dtype-independent) and, for bf16
            # models, images pre-cast host-side — the model's first op is
            # astype(compute_dtype), so this is the identical rounding one
            # convert earlier. Bit-identical math, ~2.7x fewer bytes
            # uploaded per step.
            img, seg, valid, full_seg, is_last = batch
            if self.cfg.dtype == "bfloat16":
                import ml_dtypes
                img = np.asarray(img).astype(ml_dtypes.bfloat16)
            batch = (img, np.asarray(seg).astype(np.int8),
                     valid, full_seg, is_last)
        if self.mesh is not None:
            return shard_batch(self.mesh, batch)
        return jax.tree_util.tree_map(jnp.asarray, batch)

    def _val_objscores(self, probs, inst, valid) -> Tuple[float, float]:
        """Per-object (SEG, DET) on postprocessed validation predictions
        (SURVEY.md §2 "Validation metric": per-object Jaccard on connected
        components; DET added r4 as a second selection signal — it reacts
        to FN/FP/split errors SEG's Jaccard mean can mask). Runs the SAME
        on-device postprocess as inference (threshold → CCL → min-size →
        marker growth) on every annotated frame of the val window and
        scores metrics/seg.py + metrics/det.py against the instance GT
        carried by the val reader."""
        from ..metrics import det_counts, seg_measure
        from ..metrics.det import W_FN, W_FP, W_NS
        from ..ops.postprocess import postprocess_frame

        total, count = 0.0, 0
        ns = fn = fp = n_ref = 0
        b_n, t_n = valid.shape
        for b in range(b_n):
            for t in range(t_n):
                if valid[b, t] <= 0:
                    continue
                lab = np.asarray(postprocess_frame(
                    probs[b, t], min_cell_size=self.p.val_seg_min_cell_size))
                s, n = seg_measure(inst[b, t], lab)
                total += s
                count += n
                cs, cn, cp, cg = det_counts(inst[b, t], lab)
                ns += cs
                fn += cn
                fp += cp
                n_ref += cg
        seg = total / count if count else 0.0
        det = (1.0 - min(W_NS * ns + W_FN * fn + W_FP * fp,
                         W_FN * n_ref) / (W_FN * n_ref)) if n_ref else 0.0
        return seg, det

    def _val_seg(self, probs, inst, valid) -> float:
        # unbound-callable on purpose: tests drive it with a bare namespace
        return Trainer._val_objscores(self, probs, inst, valid)[0]

    # ------------------------------------------------------------------

    def train(self, num_iterations: Optional[int] = None) -> Dict[str, float]:
        p = self.p
        if num_iterations is not None:
            # explicit argument: run exactly this many MORE steps
            # (programmatic callers/tests drive incremental training)
            n_iter = num_iterations
        elif p.continue_run and self.global_step > 0:
            # config knob on a resumed run: train up to the run's recorded
            # TOTAL-step target (__init__; seeded fine-tunes target
            # seed_step + num_iterations) and stop, rather than adding
            # another full budget each restart (caught live: a supervisor
            # relaunch from step 9000 with num_iterations=10000 ran merrily
            # past 10000). Legacy run dirs without a target file fall back
            # to num_iterations-as-total.
            if self.target_step is not None:
                # effective target honors BOTH the recorded budget and a
                # raised num_iterations: a seeded fine-tune keeps its
                # initial_step+num_iterations target across relaunches,
                # while relaunching an unseeded run with a bigger
                # num_iterations still extends it (the established way to
                # lengthen a run)
                target = max(self.target_step,
                             self.initial_step + p.num_iterations)
                if target > self.target_step:
                    self.target_step = target
                    self._write_target()
            else:
                target = p.num_iterations  # legacy run dir, no target file
            n_iter = max(0, target - self.global_step)
            log_print(f"continue_run: {n_iter} steps remain to the "
                      f"total-step target {target}")
        else:
            n_iter = p.num_iterations
        if hasattr(self.reader, "set_start_step"):
            # deterministic providers resume the input stream exactly where
            # the restored checkpoint left off (continue_run)
            self.reader.set_start_step(self.global_step)
        self.reader.start_queues()
        if self.val_reader:
            self.val_reader.start_queues()

        lstm_state = self._fresh_state()
        val_state = self._fresh_state() if self.val_reader else None
        last: Dict[str, float] = {}
        metrics: Dict[str, Any] = {}
        t0 = time.time()
        frames_done = 0
        # loss-spike rollback guard state (see CTCParams.spike_factor)
        spike_ema: Optional[float] = None
        spike_last_rollback = -(10 ** 9)
        spike_rollbacks = 0
        spike_pending: Dict[str, Any] = {}  # last step's un-fetched metrics

        profiling = False
        watchdog = None
        if p.watchdog_secs > 0:
            # armed BEFORE the first step so the timeout must also cover
            # first-step compile + restore; fed once per loop iteration —
            # a wedge stalls the loop itself (donation makes dispatch N+1
            # block on step N)
            from ..utils.watchdog import StallWatchdog
            watchdog = StallWatchdog(p.watchdog_secs, label="train").start()
        try:
            for it in range(n_iter):
                if watchdog:
                    watchdog.feed()
                batch = self._put(self.reader.get_batch())
                img, seg, valid, full_seg, is_last = batch

                if p.profile and not p.dry_run and it == 10:
                    jax.profiler.start_trace(p.experiment_log_dir)
                    profiling = True
                (self.model_params, self.opt_state, lstm_state, metrics
                 ) = self.step_fn(self.model_params, self.opt_state,
                                  lstm_state, img, seg, valid, full_seg, is_last)
                if profiling and it >= 15:
                    jax.tree_util.tree_map(
                        lambda x: x.block_until_ready(), metrics)
                    jax.profiler.stop_trace()
                    profiling = False

                self.global_step += 1
                frames_done += img.shape[0] * img.shape[1]

                if p.spike_factor > 0:
                    # Lag-1 spike check: fetch the PREVIOUS step's loss,
                    # only after this step is already dispatched. A float()
                    # on the fresh metrics forces a full host<->device sync
                    # per step, which stalls dispatch. With the one-step lag
                    # the fetch overlaps the in-flight step, so dispatch
                    # stays pipelined — and catching a spike one step late
                    # is free, because rollback restores the last
                    # checkpoint either way.
                    loss_now = (float(spike_pending["loss"])
                                if spike_pending else None)
                    spike_pending = metrics
                    armed = (it >= p.spike_warmup
                             and self.global_step - spike_last_rollback
                             >= p.spike_cooldown)
                    spiked = (loss_now is not None and spike_ema is not None
                              and armed
                              and (not np.isfinite(loss_now)
                                   or loss_now > p.spike_factor
                                   * max(spike_ema, 1e-8)))
                    if spiked:
                        spike_rollbacks += 1
                        if spike_rollbacks > p.spike_max_rollbacks:
                            raise RuntimeError(
                                f"spike guard: {spike_rollbacks} rollbacks — "
                                f"recurring divergence, aborting (check LR / "
                                f"data)")
                        log_print(
                            f"SPIKE at step {self.global_step - 1}: "
                            f"loss={loss_now:.4f} > {p.spike_factor:.1f} x "
                            f"EMA {spike_ema:.4f} — rolling back to last "
                            f"checkpoint ({spike_rollbacks}/"
                            f"{p.spike_max_rollbacks})")
                        self._rollback()
                        lstm_state = self._fresh_state()
                        spike_last_rollback = self.global_step
                        # the step dispatched above ran FROM the spiked
                        # weights — its loss must not feed the EMA or
                        # re-trigger the guard
                        spike_pending = {}
                        if self.tb:
                            self.tb.add_scalar("train/spike_rollback", 1.0,
                                               self.global_step)
                    elif loss_now is not None and np.isfinite(loss_now):
                        d = p.spike_ema_decay
                        spike_ema = (loss_now if spike_ema is None
                                     else d * spike_ema + (1 - d) * loss_now)

                if (it + 1) % p.print_to_console_interval == 0 or it == 0:
                    last = {k: float(v) for k, v in metrics.items()}
                    dt = time.time() - t0
                    fps = frames_done / max(dt, 1e-9)
                    log_print(
                        f"step {self.global_step}: loss={last['loss']:.4f} "
                        f"acc={last['accuracy']:.4f} gnorm={last['grad_norm']:.3f} "
                        f"({fps:.1f} frames/s)")
                    t0, frames_done = time.time(), 0

                if self.tb and (it + 1) % p.write_to_tb_interval == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    for k, v in m.items():
                        self.tb.add_scalar(f"train/{k}", v, self.global_step)

                if self.val_reader and (it + 1) % p.validation_interval == 0:
                    if watchdog:
                        # bound the validation segment separately: eval-step
                        # first-compile + host-side SEG can legitimately
                        # push one iteration past the timeout
                        watchdog.feed()
                    (vimg_h, vseg_h, vvalid_h, vfull_h, vlast_h,
                     vinst) = self.val_reader.get_batch()
                    vimg, vseg, vvalid, vfull, vlast = self._put(
                        (vimg_h, vseg_h, vvalid_h, vfull_h, vlast_h))
                    val_state, vm, vprobs = self.eval_fn(
                        self.model_params, val_state, vimg, vseg, vvalid,
                        vfull, vlast)
                    vm = {k: float(v) for k, v in vm.items()}
                    vm["seg"], vm["det"] = self._val_objscores(
                        vprobs, vinst, vvalid_h)
                    self.last_val_metrics = vm
                    log_print(f"  val: loss={vm['loss']:.4f} "
                              f"acc={vm['accuracy']:.4f} "
                              f"seg={vm['seg']:.4f} "
                              f"det={vm['det']:.4f} "
                              f"seg_proxy={vm['seg_proxy']:.4f}")
                    if self.tb:
                        for k, v in vm.items():
                            self.tb.add_scalar(f"val/{k}", v, self.global_step)
                        # image summaries: input / GT / prediction of lane 0,
                        # last frame (reference: tf.summary images [M])
                        x = np.asarray(vimg[0, -1, :, :, 0],
                                       dtype=np.float32)  # bf16-safe for TB
                        x = (x - x.min()) / max(x.max() - x.min(), 1e-6)
                        self.tb.add_image("val/input", x[None], self.global_step)
                        self.tb.add_image(
                            "val/gt", np.asarray(vseg[0, -1])[None] / 2.0,
                            self.global_step)
                        vpred0 = np.argmax(np.asarray(vprobs[0, -1]), -1)
                        self.tb.add_image(
                            "val/pred", vpred0[None] / 2.0, self.global_step)

                if self.ckpt and (it + 1) % p.save_checkpoint_iteration == 0:
                    if watchdog:
                        watchdog.feed()  # bound the save segment separately
                    self._save_checkpoint()

                if p.rss_relaunch_gb > 0 and (it + 1) % _RSS_CHECK_EVERY == 0:
                    rss = rss_gb()
                    if rss > p.rss_relaunch_gb:
                        # exit with the watchdog code: the finally block
                        # below runs the normal final save first, then a
                        # supervisor relaunches with continue_run and host
                        # RSS resets (see CTCParams.rss_relaunch_gb)
                        log_print(
                            f"host RSS {rss:.1f} GB > rss_relaunch_gb="
                            f"{p.rss_relaunch_gb:g} at step "
                            f"{self.global_step} — saving and exiting "
                            f"{STALL_EXIT_CODE} for a supervisor relaunch")
                        raise SystemExit(STALL_EXIT_CODE)

            # drain the lag-1 spike check: the last dispatched step has not
            # been inspected yet — roll back before the final save captures
            # a spiked iterate
            if (p.spike_factor > 0 and spike_pending
                    and spike_ema is not None
                    and spike_rollbacks <= p.spike_max_rollbacks):
                loss_now = float(spike_pending["loss"])
                if (not np.isfinite(loss_now)
                        or loss_now > p.spike_factor * max(spike_ema, 1e-8)):
                    log_print(
                        f"SPIKE at final step {self.global_step}: "
                        f"loss={loss_now:.4f} > {p.spike_factor:.1f} x EMA "
                        f"{spike_ema:.4f} — rolling back before the final "
                        f"save")
                    self._rollback()
        finally:
            if profiling:  # stop leaked traces (short runs / exceptions)
                try:
                    jax.profiler.stop_trace()
                except Exception:
                    pass
            self.reader.stop()
            if self.val_reader:
                self.val_reader.stop()
            if watchdog:
                watchdog.feed()  # bound the final barrier save separately
            if self.ckpt:
                self._save_checkpoint(final=True)
            if watchdog:
                # disarm only after the save: a wedge during the final
                # device->host drain is as real as one mid-step (the
                # supervisor relaunch then resumes at the last good save)
                watchdog.stop()
            if self.tb:
                self.tb.close()
        if not last and metrics:
            last = {k: float(v) for k, v in metrics.items()}
        return last
