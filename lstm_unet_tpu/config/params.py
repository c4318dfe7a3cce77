"""Typed configuration layer.

Reference parity: ``Params.py`` in arbellea/LSTM-UNet (SURVEY.md §2, L0 layer)
defines ``ParamsBase`` / ``CTCParams`` / ``CTCInferenceParams`` as attribute-bag
classes whose attributes ARE the config, with CLI argparse overrides mutating
instances and derived experiment dirs computed in ``__init__``.

This rebuild keeps the knob NAMES (``unroll_len``, ``net_kernel_params``,
``min_cell_size``, ``FOV``, ``pre_sequence_frames`` …) so reference configs
translate, but uses typed dataclasses with a JSON round-trip instead of
pickle (SURVEY.md §5 "Config / flag system").

``net_kernel_params`` schema is preserved verbatim from the reference:
per-level lists of ``(kernel_size, num_filters)`` tuples under the keys
``down_conv_kernels`` / ``lstm_kernels`` / ``up_conv_kernels``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

# --------------------------------------------------------------------------
# net_kernel_params
# --------------------------------------------------------------------------

# Per-level list of (kernel_size, filters); one outer list entry per U-Net level.
LevelSpec = List[List[Tuple[int, int]]]


@dataclass
class NetKernelParams:
    """Architecture description (reference: Params.py ``net_kernel_params`` [M]).

    - ``lstm_kernels[i]``      — ConvLSTM layer(s) at encoder level i
    - ``down_conv_kernels[i]`` — conv stack after the ConvLSTM at level i
    - ``up_conv_kernels[i]``   — conv stack at decoder level i (same count of
      levels; decoder runs in reverse spatial order)

    The final 1x1 conv to ``num_classes`` logits is always appended by the
    model (reference: Networks.py::ULSTMnet2D final 1x1 conv → 3 logits [M]).
    """

    lstm_kernels: LevelSpec
    down_conv_kernels: LevelSpec
    up_conv_kernels: LevelSpec

    def __post_init__(self):
        d = len(self.down_conv_kernels)
        if not (len(self.lstm_kernels) == len(self.up_conv_kernels) == d):
            raise ValueError(
                "lstm_kernels / down_conv_kernels / up_conv_kernels must have "
                f"the same number of levels, got {len(self.lstm_kernels)}/"
                f"{d}/{len(self.up_conv_kernels)}"
            )
        # normalize to tuples so JSON round-trips compare equal
        self.lstm_kernels = [[tuple(k) for k in lvl] for lvl in self.lstm_kernels]
        self.down_conv_kernels = [[tuple(k) for k in lvl] for lvl in self.down_conv_kernels]
        self.up_conv_kernels = [[tuple(k) for k in lvl] for lvl in self.up_conv_kernels]

    @property
    def depth(self) -> int:
        return len(self.down_conv_kernels)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "lstm_kernels": self.lstm_kernels,
            "down_conv_kernels": self.down_conv_kernels,
            "up_conv_kernels": self.up_conv_kernels,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NetKernelParams":
        return cls(
            lstm_kernels=d["lstm_kernels"],
            down_conv_kernels=d["down_conv_kernels"],
            up_conv_kernels=d["up_conv_kernels"],
        )


def default_net_kernel_params() -> NetKernelParams:
    """Default 4-level architecture.

    Reconstructed from the reference defaults [M] (SURVEY.md §2 "Train config"):
    per-level ConvLSTM (5x5) feeding a 2-conv stack, filter widths doubling
    with depth. Exact reference filter counts are unverifiable (empty mount);
    these match the paper-scale model (~tens of M params).
    """
    return NetKernelParams(
        lstm_kernels=[[(5, 128)], [(5, 256)], [(5, 256)], [(5, 512)]],
        down_conv_kernels=[
            [(3, 128), (3, 128)],
            [(3, 256), (3, 256)],
            [(3, 256), (3, 256)],
            [(3, 512), (3, 512)],
        ],
        up_conv_kernels=[
            [(3, 128), (3, 128)],
            [(3, 256), (3, 256)],
            [(3, 256), (3, 256)],
            [(3, 512), (3, 512)],
        ],
    )


def tiny_net_kernel_params() -> NetKernelParams:
    """Small 2-level architecture for tests / smoke runs."""
    return NetKernelParams(
        lstm_kernels=[[(3, 8)], [(3, 16)]],
        down_conv_kernels=[[(3, 8)], [(3, 16)]],
        up_conv_kernels=[[(3, 8)], [(3, 16)]],
    )


# --------------------------------------------------------------------------
# ParamsBase
# --------------------------------------------------------------------------


@dataclass
class ParamsBase:
    """Base config (reference: Params.py::ParamsBase [M]).

    Derives timestamped experiment log/save dirs from ``experiment_name``
    under ``root_save_dir`` and resolves checkpoint-continuation paths.
    """

    experiment_name: str = "MyRun"
    root_save_dir: str = "./runs"
    dry_run: bool = False  # reference: params.dry_run skips all writes [M]
    # derived (filled by resolve_dirs)
    experiment_log_dir: Optional[str] = None
    experiment_save_dir: Optional[str] = None

    def resolve_dirs(self, timestamp: Optional[str] = None) -> None:
        ts = timestamp or time.strftime("%Y-%m-%d_%H%M%S")
        base = os.path.join(self.root_save_dir, f"{self.experiment_name}_{ts}")
        self.experiment_log_dir = os.path.join(base, "logs")
        self.experiment_save_dir = os.path.join(base, "ckpt")
        if not self.dry_run:
            os.makedirs(self.experiment_log_dir, exist_ok=True)
            os.makedirs(self.experiment_save_dir, exist_ok=True)

    def resolve_continue_dirs(self) -> bool:
        """Reuse the most recent existing experiment dir for this
        ``experiment_name`` (continue_run without an explicit
        load_checkpoint_path — the reference resumes from the checkpoint
        paths derived in Params.__init__ [M]). The timestamp format sorts
        lexicographically == chronologically. Returns False when no prior
        run exists (caller falls back to :meth:`resolve_dirs`)."""
        import glob as _glob

        pattern = os.path.join(self.root_save_dir, f"{self.experiment_name}_*")
        runs = sorted(
            d for d in _glob.glob(pattern)
            if os.path.isdir(os.path.join(d, "ckpt")))
        if not runs:
            return False
        base = runs[-1]
        self.experiment_log_dir = os.path.join(base, "logs")
        self.experiment_save_dir = os.path.join(base, "ckpt")
        return True

    # ---- JSON round-trip (replaces the reference's pickle; SURVEY.md §5) ----

    def to_json(self) -> str:
        def enc(o):
            if isinstance(o, NetKernelParams):
                return o.to_dict()
            raise TypeError(type(o))

        return json.dumps(dataclasses.asdict(self), default=enc, indent=2)

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_json(cls, s: str):
        d = json.loads(s)
        return cls.from_dict(d)

    @classmethod
    def load_json(cls, path: str):
        with open(path) as f:
            return cls.from_json(f.read())

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in fields:
                continue
            if k == "net_kernel_params" and isinstance(v, dict):
                v = NetKernelParams.from_dict(v)
            kwargs[k] = v
        return cls(**kwargs)

    def override(self, **kwargs):
        """Apply CLI-style overrides (reference: argparse mutates Params [M])."""
        for k, v in kwargs.items():
            if v is None:
                continue
            if not hasattr(self, k):
                raise AttributeError(f"unknown param: {k}")
            setattr(self, k, v)
        return self


# --------------------------------------------------------------------------
# CTCParams — training
# --------------------------------------------------------------------------


@dataclass
class CTCParams(ParamsBase):
    """Training config (reference: Params.py::CTCParams [H], knobs [M]).

    Knob names follow the reference so configs translate (SURVEY.md §5).
    """

    # data
    root_data_dir: str = "./data/CTC"
    # list of (dataset_name, sequence_id) pairs, e.g. [("Fluo-N2DH-SIM+", "01")]
    train_sequence_list: List[Tuple[str, str]] = field(
        default_factory=lambda: [("Fluo-N2DH-SIM+", "01"), ("Fluo-N2DH-SIM+", "02")]
    )
    val_sequence_list: List[Tuple[str, str]] = field(default_factory=list)
    data_provider_class: str = "CTCRAMReaderSequence2D"
    crop_size: Tuple[int, int] = (256, 256)  # reference crop [M]
    batch_size: int = 5       # reference ≈5 [M]
    unroll_len: int = 7       # reference ≈7 [M]
    data_format: str = "NHWC"  # only layout (reference offered NCHW/NHWC [M])
    # one producer thread: the trainer carries LSTM state across consecutive
    # batches, so the batch stream must be a single ordered lane set
    num_prefetch_threads: int = 1
    elastic_augmentation: bool = False
    randomize: bool = True
    # None = auto: _ST silver truth and "SIM" datasets are fully annotated,
    # gold _GT on real datasets is partial (only labeled pixels train)
    gt_is_full_seg: Optional[bool] = None

    # model
    net_kernel_params: NetKernelParams = field(default_factory=default_net_kernel_params)
    num_classes: int = 3  # bg / interior / boundary [H]
    activation: str = "leaky_relu"   # conv-stack activation [L — verify]
    recurrent_activation: str = "sigmoid"  # 'hard_sigmoid' for Keras-2.0 parity
    norm: str = "none"               # optional 'layernorm' (BN presence in ref is [M])
    dtype: str = "float32"           # compute dtype; 'bfloat16' for speed
    state_dtype: str = "auto"        # LSTM carry dtype; 'float32' to resist
                                     # drift on very long streams under bf16

    # optimization
    learning_rate: float = 1e-5      # reference ~1e-5 [M]
    # global-norm gradient clipping; 0 disables. BPTT through ConvLSTMs can
    # spike (observed: a stable run exploding to gnorm ~2e6 in one step) —
    # clipping is cheap insurance the reference lacked
    grad_clip_norm: float = 5.0
    # wrap the optimizer in optax.apply_if_finite: a step with non-finite
    # grads is skipped instead of poisoning params (failure containment the
    # reference lacked — SURVEY.md §5 failure-detection row)
    skip_nonfinite_updates: bool = True
    # Adam first-moment (mu) storage dtype; 'bfloat16' halves mu bytes and
    # the per-step traffic it drags. nu stays f32 (second moments need the
    # range). Update math is still f32 — optax casts mu per step.
    adam_mu_dtype: str = "float32"
    num_iterations: int = 100000
    class_weights: Tuple[float, float, float] = (0.15, 0.25, 0.6)  # bg/interior/boundary [M]

    # bookkeeping
    validation_interval: int = 1000
    # min component size for the per-object SEG scored during validation
    # (the postprocess run on val predictions — see Trainer._val_seg)
    val_seg_min_cell_size: int = 10
    print_to_console_interval: int = 100
    save_checkpoint_iteration: int = 5000
    write_to_tb_interval: int = 500
    save_checkpoint_max_to_keep: int = 5
    # periodic saves snapshot to non-donated device buffers and drain
    # asynchronously (no step-loop stall); False restores the save+barrier
    # behavior (the final save always barriers)
    async_checkpoint: bool = True
    load_checkpoint: bool = False
    load_checkpoint_path: str = ""
    continue_run: bool = False
    profile: bool = False
    # stalled-step failure detector (no reference analog — SURVEY.md §5
    # failure-detection row). >0 arms utils.watchdog.StallWatchdog: if no
    # training step completes for this many seconds the process hard-exits
    # with code 17 so a supervisor can relaunch with continue_run. Covers a
    # wedged device client (threads parked, zero CPU, no exception —
    # unrecoverable in-process). 0 disables.
    watchdog_secs: float = 0.0

    # loss-spike rollback guard (no reference analog — SURVEY.md §5
    # failure-recovery row; motivated by the measured v3bw incident: a
    # FINITE loss spike at step 8500 permanently damaged held-out transfer
    # even though crop-val recovered — BASELINE.md). When train loss exceeds
    # spike_factor x its EMA (after spike_warmup steps), the trainer
    # restores params/opt_state from the run's last checkpoint, resets the
    # LSTM carry, and keeps the READER POSITION — the deterministic stream
    # moves on, so the rolled-back weights meet different data instead of
    # deterministically replaying the same spike. 0 disables (default, for
    # reference parity); unattended recipes arm it.
    spike_factor: float = 0.0
    spike_ema_decay: float = 0.98   # EMA of per-step loss
    spike_warmup: int = 50          # steps before the guard arms
    spike_cooldown: int = 100       # min steps between rollbacks
    spike_max_rollbacks: int = 5    # then fail loudly (data/LR is wrong)

    # Host-RSS relaunch guard (no reference analog — SURVEY.md §5 failure
    # detection): when VmRSS exceeds this many GB the trainer exits 17
    # after the normal final save, for a supervisor relaunch with
    # continue_run. 0 (default) disables; ROADMAP D3 decides whether the
    # guard stays.
    rss_relaunch_gb: float = 0.0

    # Compact batch uploads (~2.7x fewer host-to-device bytes per step):
    # labels upload as int8 (one_hot/compare semantics are dtype-independent
    # — bit-identical) and, when dtype='bfloat16', images pre-cast host-side
    # to bf16 — the model's first op is astype(compute_dtype)
    # (models/ulstm_unet.py::step), so the rounding is the same convert XLA
    # would do (bit-identical).
    compact_upload: bool = True

    # parallel (new in the rebuild; no reference analog — SURVEY.md §2 checklist)
    mesh_shape: Dict[str, int] = field(default_factory=lambda: {"data": 1})
    # jax.checkpoint the scan body during BPTT (trades recompute for
    # activation memory; ROADMAP S8 measures the policies on the card)
    remat: bool = True
    # 'full': recompute the whole scan body (maximum memory savings);
    # 'save_outputs': keep per-level ConvLSTM/conv-stack outputs and
    # recompute only glue (less recompute, more memory) —
    # models/ulstm_unet.py::apply
    remat_policy: str = "full"
    # float conv lowering (ops/conv.py): 'dots' replaces conv layout
    # assignment (and the conv-transpose grads in BPTT) with shifted-tap
    # matmuls at large-spatial levels; 'auto' = 'conv'. Process-wide
    # (module flag) — set once per run by the engine.
    conv_method: str = "conv"
    # AOT-compile the train step with AUTO entry/exit layouts for the
    # cycled operands (params/opt_state/lstm_state) — one-time relayout
    # instead of per-step in-program conv-kernel layout copies.
    # Single-device only; falls back loudly if XLA's exit formats differ
    # from its entry formats. A/B knob (ROADMAP D2).
    entry_layouts: bool = False


# --------------------------------------------------------------------------
# CTCInferenceParams
# --------------------------------------------------------------------------


@dataclass
class CTCInferenceParams(ParamsBase):
    """Inference config (reference: Params.py::CTCInferenceParams [H], knobs [M])."""

    model_path: str = ""           # dir with step ckpts + model_params.json
    ckpt_step: int = 0             # restore this saved step (0 = latest) —
                                   # model selection on val/seg without
                                   # touching the model dir
    sequence_path: str = ""        # dir of t*.tif frames
    output_path: str = "./output"
    filename_format: str = "t*.tif"   # reference default [M]
    data_format: str = "NHWC"
    FOV: int = 0                   # CTC field-of-view border rule [M]
    min_cell_size: int = 10        # drop instances smaller than this [M]
    max_cell_size: int = 0         # 0 = unlimited
    edge_thresh: float = 0.3       # boundary-probability threshold [M]
    cell_thresh: float = 0.5       # interior-probability threshold [M]
    # boundary-band label growth: 'marker' = nearest-marker growth to band
    # exhaustion (reference's marker-based region growth [M]), 'dilate' =
    # fixed-round max-label dilation, 'none'. grow_iters caps the rounds
    # (0 = exhaustion for 'marker', 3 for 'dilate').
    boundary_growth: str = "marker"
    grow_iters: int = 0
    # split merged components of touching cells along their distance-
    # transform ridge (ops/postprocess.py::split_touching_instances) —
    # watershed-style separation of touching cells (SURVEY.md §3.2 [M] at
    # its real intent). Off by default for reference parity; the quality
    # recipe for dense/occluded data enables it.
    instance_split: bool = False
    # 'dist' = distance-transform ridge markers (geometry; measured negative
    # on model outputs across its grid — BASELINE.md session 6); 'prob' =
    # hysteresis markers from the model's own p(cell) dips
    # (ops/postprocess.py::split_touching_instances_prob)
    split_method: str = "dist"
    split_window: int = 16     # dist: regional-max window radius (px)
    split_min_dist: int = 4    # dist: min distance-to-background for a marker (px)
    split_slack: int = 1       # dist: h-maxima tolerance bridging DT terraces (px)
    split_rel: float = 0.65    # dist: marker must reach rel * wider-window max
    split_rel_window: int = 48  # dist: the wider window for the relative rule (px)
    split_min_size: int = 0    # only components >= this size are split (px)
    split_hi_thresh: float = 0.8  # prob: marker threshold on p(cell)
    split_erode: int = 1       # prob: marker erosion rounds (kills px bridges)
    # 'pre' (reference [M]): min/max_cell_size filter interiors BEFORE
    # boundary growth; 'post': filter the GROWN extent — occlusion
    # crescents with tiny visible interiors still seed growth
    size_filter: str = "pre"
    # flip test-time augmentation: stream the 4 flip variants as extra
    # batch lanes (each with its own LSTM state), average the unflipped
    # softmax probs before postprocess. 4x model compute for a quality
    # bump; off by default (no reference analog) — engine/infer.py.
    tta: bool = False
    # 'flip' = 4 axis-flip variants; 'd4' = the full 8-element dihedral
    # group (adds the 4 transposed variants — frames pad to a SQUARE so
    # transposes batch with the rest; 8x model compute)
    tta_mode: str = "flip"
    pre_sequence_frames: int = 4   # LSTM warm-up: initial frames fed reversed [M]
    save_intermediate: bool = False
    save_intermediate_path: str = ""
    dtype: str = "bfloat16"
    state_dtype: str = "auto"      # 'float32': f32 LSTM carry for unbounded
                                   # streams under bf16 compute
    # conv lowering selection, same contract as CTCParams.conv_method;
    # int8 runs use the (bit-identical) int8 twin in ops/quant.py
    conv_method: str = "conv"
    # Mixed-precision int8 serving: comma-separated site-name prefixes
    # (models/ulstm_unet.py collect_scales keys, e.g. "encoder/0" or
    # "encoder/0/lstm,decoder/0") whose convs/cells stay bf16 inside an
    # otherwise-int8 tree (ops/quant.py::quantize_params_int8 keep_float).
    # A/B knob (ROADMAP D2).
    int8_keep_float: str = ""
    # auto-reset the LSTM state when the mean abs difference between
    # consecutive normalized frames exceeds this (0 = off, reference
    # behavior: state is never reset). Motivated by the carry-drift stress
    # (BASELINE.md): abrupt scene changes saturate the carried state and
    # degrade quality in either precision; a reset recovers fresh-stream
    # behavior at the cost of pre_sequence-style cold-start on the cut.
    reset_on_jump: float = 0.0
    digit_4: bool = False          # True → mask%04d.tif (long sequences, e.g. PSC)
    # Stall watchdog for unattended eval/sweep runs, same contract as
    # CTCParams.watchdog_secs (>0 arms utils.watchdog.StallWatchdog, fed per
    # FRAME; a wedged device client hard-exits 17 so a supervisor relaunch
    # can rerun the stage). Must cover the first-step compile.
    watchdog_secs: float = 0.0
    # AOT-compile the streaming step with AUTO entry layouts for the model
    # params and device_put the weights into the executable's preferred
    # layouts ONCE (jax.experimental.layout). Default entry layouts may
    # force XLA to re-lay-out conv kernels inside the program each frame.
    # Single-device path only; A/B knob until measured on the card
    # (ROADMAP D2).
    entry_layouts: bool = False
    # multi-device streaming (no reference analog): 'data' shards batched
    # sequences, 'spatial' shards frame height (XLA inserts conv halos)
    mesh_shape: Dict[str, int] = field(default_factory=dict)


# --------------------------------------------------------------------------
# Named recipes (no reference analog: the reference ships one hardcoded
# default per knob; this repo additionally ships the measured-best recipe —
# configs/recommended.json — so the BASELINE.md headline reproduces with one
# flag instead of nine)
# --------------------------------------------------------------------------


def load_recipe(path: str, known: Optional[set] = None) -> Dict[str, Any]:
    """Load a named knob recipe for ``--recipe`` CLI flags.

    Accepts either a flat knob dict (e.g. ``configs/recommended.json``) or a
    ``scripts/calibrate_recipe.py`` output file (its ``"winner"`` dict is
    used). Keys are CTCParams / CTCInferenceParams knob names shared by the
    train and inference CLIs; each CLI passes ``known`` to keep only the
    keys it understands. ``"fov"`` is accepted as an alias for ``"FOV"``,
    lists become tuples (class_weights / crop_size), and a recipe that turns
    on ``instance_split`` without naming a ``split_method`` gets the
    measured-best ``"prob"`` splitter (BASELINE.md r3).
    """
    with open(path) as f:
        d = json.load(f)
    if isinstance(d.get("winner"), dict):
        d = d["winner"]
    d = {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()}
    if "fov" in d and "FOV" not in d:
        d["FOV"] = d.pop("fov")
    if d.get("instance_split") and "split_method" not in d:
        d["split_method"] = "prob"
    if known is not None:
        d = {k: v for k, v in d.items() if k in known}
    return d
