"""Full CTC 2D benchmark sweep (BASELINE.json config #5).

Runs batched multi-sequence streaming inference over every sequence of every
dataset found under ``--root_data_dir``, writing CTC-format ``<seq>_RES``
directories. Sequences are grouped by frame shape so each group streams as
one batched jitted program.

No direct reference analog — the reference runs Inference2D.py once per
sequence by hand; this driver is the sweep the reference README describes
operationally (download → infer each sequence → submit).

Usage:
    python -m lstm_unet_tpu.cli.ctc_sweep --model_path runs/X/ckpt \
        --root_data_dir ./data/CTC --output_root ./results
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from collections import defaultdict

from ..config import CTCInferenceParams
from ..engine.infer import load_model, run_inference_batched
from ..io.tiff import read_tiff
from ..utils import log_print
from ..utils.compile_cache import enable_compile_cache


def find_sequences(root: str):
    """Yield (dataset, seq, seq_dir) for every CTC sequence under root."""
    for ds in sorted(os.listdir(root)):
        ds_dir = os.path.join(root, ds)
        if not os.path.isdir(ds_dir):
            continue
        for seq in sorted(os.listdir(ds_dir)):
            seq_dir = os.path.join(ds_dir, seq)
            if (os.path.isdir(seq_dir) and not seq.endswith(("_GT", "_ST", "_RES"))
                    and glob.glob(os.path.join(seq_dir, "t*.tif"))):
                yield ds, seq, seq_dir


def _aligned_gt_pred(gt_dir: str, pattern: str, out_dir: str):
    """Pair GT frames in ``gt_dir`` with the swept masks (GT may be sparse)."""
    import re

    from ..io.dataset import _frame_index

    idx_re = re.compile(re.escape(pattern).replace(r"\*", r"(\d+)") + "$")
    gts, preds = [], []
    for g in sorted(glob.glob(os.path.join(gt_dir, pattern))):
        idx = _frame_index(g, idx_re)
        if idx is None:
            continue
        for fmt in ("mask%03d.tif", "mask%04d.tif"):
            mp = os.path.join(out_dir, fmt % idx)
            if os.path.exists(mp):
                gts.append(read_tiff(g))
                preds.append(read_tiff(mp))
                break
    return gts, preds


# Infrastructure args (paths, stage control): must never come from a
# recipe file, whatever keys it carries.
_RECIPE_INFRA = {"model_path", "root_data_dir", "output_root", "seqs",
                 "ckpt_step", "calibrate", "watchdog_secs", "recipe",
                 "save_intermediate", "score_seg", "score_det", "help"}


def apply_recipe(ap, args, argv=None) -> dict:
    """Overlay ``args.recipe`` knobs onto parsed ``args`` in place.

    Explicit CLI flags win over recipe keys (same semantics as
    inference2d): a flag counts as explicit when its option string appears
    on the command line — plain setattr over parse_args output cannot
    distinguish defaults from explicit values. Returns the applied dict.
    """
    if not args.recipe:
        return {}
    from ..config import load_recipe

    knob_dests = {a.dest for a in ap._actions} - _RECIPE_INFRA
    recipe = load_recipe(args.recipe, known=knob_dests)
    toks = {t.split("=", 1)[0] for t in
            (argv if argv is not None else sys.argv[1:])
            if t.startswith("--")}
    # argparse accepts unambiguous prefix abbreviations (--recip ==
    # --recipe), so explicit-flag detection must too (ADVICE r4): a token
    # counts as naming an option when it is a prefix of the option string.
    # An AMBIGUOUS prefix never reaches here — parse_args errors out first.
    explicit = {a.dest for a in ap._actions
                if any(o.startswith(t) for o in a.option_strings
                       for t in toks if len(t) > 2)}
    applied = {k: v for k, v in recipe.items() if k not in explicit}
    for k, v in applied.items():
        setattr(args, k, v)
    skipped = {k: v for k, v in recipe.items() if k in explicit}
    log_print(f"recipe {args.recipe}: {applied}"
              + (f" (explicit flags win over {skipped})" if skipped else ""))
    return applied


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_path", type=str, required=True)
    ap.add_argument("--root_data_dir", type=str, required=True)
    ap.add_argument("--output_root", type=str, required=True)
    ap.add_argument("--min_cell_size", type=int, default=10)
    ap.add_argument("--FOV", type=int, default=0)
    ap.add_argument("--cell_thresh", type=float, default=0.5)
    ap.add_argument("--edge_thresh", type=float, default=0.3)
    ap.add_argument("--boundary_growth", type=str, default="marker",
                    choices=["marker", "dilate", "none"])
    ap.add_argument("--grow_iters", type=int, default=0)
    ap.add_argument("--conv_method", type=str, default="conv",
                    choices=["conv", "dots", "auto"],
                    help="conv lowering (ops/conv.py + int8 twin)")
    ap.add_argument("--entry_layouts", action="store_true",
                    help="AOT step with AUTO entry layouts for the weights "
                         "(one-time relayout; single-device)")
    ap.add_argument("--tta", action="store_true",
                    help="flip test-time augmentation: average softmax "
                         "probs over the 4 flip variants (4x compute)")
    ap.add_argument("--tta_mode", type=str, default="flip",
                    choices=("flip", "d4"),
                    help="'d4' adds the 4 transposed variants (full "
                         "dihedral group, 8x compute, pads square)")
    ap.add_argument("--instance_split", action="store_true",
                    help="split merged components of touching cells along "
                         "their distance-transform ridge")
    ap.add_argument("--size_filter", type=str, default="pre",
                    choices=("pre", "post"),
                    help="'post' measures min/max_cell_size on the GROWN "
                         "extent (crescents with tiny interiors survive)")
    ap.add_argument("--split_method", type=str, default="dist",
                    choices=("dist", "prob"))
    ap.add_argument("--split_window", type=int, default=16)
    ap.add_argument("--split_min_dist", type=int, default=4)
    ap.add_argument("--split_slack", type=int, default=1)
    ap.add_argument("--split_rel", type=float, default=0.65)
    ap.add_argument("--split_rel_window", type=int, default=48)
    ap.add_argument("--split_min_size", type=int, default=0)
    ap.add_argument("--split_hi_thresh", type=float, default=0.8)
    ap.add_argument("--split_erode", type=int, default=1)
    ap.add_argument("--pre_sequence_frames", type=int, default=4)
    ap.add_argument("--dtype", type=str, default="bfloat16")
    ap.add_argument("--int8_keep_float", type=str, default="",
                    help="comma-separated site prefixes kept bf16 inside an "
                         "int8 run (mixed precision, e.g. 'encoder/0')")
    ap.add_argument("--state_dtype", type=str, default="auto",
                    choices=["auto", "float32", "bfloat16"])
    ap.add_argument("--max_batch", type=int, default=4)
    ap.add_argument("--reset_on_jump", type=float, default=0.0,
                    help="auto-reset LSTM state on abrupt scene change "
                         "(mean abs frame delta threshold; 0 = off)")
    ap.add_argument("--save_intermediate", action="store_true",
                    help="also dump per-frame softmax probability maps "
                         "([H,W,3] .npy) into <seq>_RES/intermediate/ — "
                         "offline postprocess calibration input")
    ap.add_argument("--score_seg", action="store_true",
                    help="after the sweep, score SEG against <seq>_GT/SEG "
                         "ground truth where present")
    ap.add_argument("--score_det", action="store_true",
                    help="after the sweep, score the CTC DET measure "
                         "(AOGM-D) against <seq>_GT/TRA markers when "
                         "present, else <seq>_GT/SEG")
    ap.add_argument("--seqs", type=str, default="",
                    help="comma-separated sequence names to sweep (e.g. "
                         "'03' or '01,03'); default = every sequence found")
    ap.add_argument("--ckpt_step", type=int, default=0,
                    help="restore this saved checkpoint step (0 = latest) — "
                         "model selection on val/seg")
    ap.add_argument("--calibrate", type=int, default=0, metavar="N",
                    help="first calibrate int8 activation scales on the "
                         "first N frames of the first sequence (writes "
                         "act_scales.json into --model_path)")
    ap.add_argument("--watchdog_secs", type=float, default=0.0,
                    help="exit 17 if no inference frame completes for this "
                         "many seconds (wedged device client); 0 disables. "
                         "Must cover the first-step compile.")
    ap.add_argument("--recipe", type=str, default="",
                    help="knob recipe JSON (configs/recommended.json or a "
                         "scripts/calibrate_recipe.py output); explicit "
                         "flags still win over recipe keys")
    args = ap.parse_args(argv)
    apply_recipe(ap, args, argv)
    enable_compile_cache()

    if args.calibrate and args.dtype != "int8":
        # calibration writes act_scales.json into --model_path; only the
        # int8 path ever reads it — don't mutate the model dir for a run
        # that never uses the scales (ADVICE r2)
        log_print(f"--calibrate ignored: dtype={args.dtype} (int8 only)")
        args.calibrate = 0
    if args.calibrate:
        from ..engine.infer import calibrate_model_dir

        first = next(iter(find_sequences(args.root_data_dir)), None)
        if first is None:
            raise FileNotFoundError(
                f"no CTC sequences under {args.root_data_dir}")
        calibrate_model_dir(args.model_path, first[2],
                            n_frames=args.calibrate,
                            step=args.ckpt_step or None)

    ip = CTCInferenceParams(
        model_path=args.model_path, min_cell_size=args.min_cell_size,
        FOV=args.FOV, cell_thresh=args.cell_thresh,
        edge_thresh=args.edge_thresh, boundary_growth=args.boundary_growth,
        grow_iters=args.grow_iters, instance_split=args.instance_split,
        size_filter=args.size_filter,
        tta=args.tta, tta_mode=args.tta_mode, conv_method=args.conv_method,
        entry_layouts=args.entry_layouts,
        split_method=args.split_method,
        split_window=args.split_window, split_min_dist=args.split_min_dist,
        split_slack=args.split_slack, split_rel=args.split_rel,
        split_rel_window=args.split_rel_window,
        split_min_size=args.split_min_size,
        split_hi_thresh=args.split_hi_thresh, split_erode=args.split_erode,
        pre_sequence_frames=args.pre_sequence_frames,
        watchdog_secs=args.watchdog_secs,
        save_intermediate=args.save_intermediate,
        dtype=args.dtype, state_dtype=args.state_dtype,
        reset_on_jump=args.reset_on_jump,
        int8_keep_float=args.int8_keep_float,
        ckpt_step=args.ckpt_step)
    params, cfg = load_model(args.model_path, dtype=args.dtype,
                             state_dtype=args.state_dtype,
                             step=args.ckpt_step or None)

    keep_seqs = set(s.strip() for s in args.seqs.split(",") if s.strip())
    groups = defaultdict(list)  # frame shape -> [(n_frames, seq_dir, out_dir)]
    for ds, seq, seq_dir in find_sequences(args.root_data_dir):
        if keep_seqs and seq not in keep_seqs:
            continue
        frames = sorted(glob.glob(os.path.join(seq_dir, "t*.tif")))
        shape = read_tiff(frames[0]).shape
        out_dir = os.path.join(args.output_root, ds, f"{seq}_RES")
        groups[shape].append((len(frames), seq_dir, out_dir))

    total = 0
    pairs = []
    for shape, items in groups.items():
        # batch similar-LENGTH sequences together: exhausted lanes keep
        # stepping under the static-shape jit (run_inference_batched), so a
        # short lane batched with a long one wastes ~1/B of the device for the
        # tail — length-sorted chunks minimize that tail
        items = [(s, o) for _, s, o in sorted(items, key=lambda x: x[0])]
        log_print(f"sweep: {len(items)} sequence(s) at {shape}")
        for i in range(0, len(items), args.max_batch):
            chunk = items[i: i + args.max_batch]
            total += run_inference_batched(
                ip, [s for s, _ in chunk], [o for _, o in chunk],
                params=params, cfg=cfg)
            pairs.extend(chunk)
    log_print(f"sweep complete: {total} masks")

    if args.score_seg or args.score_det:
        from ..metrics import det_measure_sequence, seg_measure_sequence

        for seq_dir, out_dir in pairs:
            if args.score_seg:
                gts, preds = _aligned_gt_pred(seq_dir + "_GT/SEG",
                                              "man_seg*.tif", out_dir)
                if gts:
                    score = seg_measure_sequence(gts, preds)
                    log_print(f"SEG {seq_dir}: {score:.4f} "
                              f"({len(gts)} annotated frames)")
            if args.score_det:
                # official DET scores against the dense TRA markers; fall
                # back to the (possibly sparse) SEG masks when a dataset
                # carries no TRA ground truth
                gts, preds = _aligned_gt_pred(seq_dir + "_GT/TRA",
                                              "man_track*.tif", out_dir)
                if not gts:
                    gts, preds = _aligned_gt_pred(seq_dir + "_GT/SEG",
                                                  "man_seg*.tif", out_dir)
                if gts:
                    score = det_measure_sequence(gts, preds)
                    log_print(f"DET {seq_dir}: {score:.4f} "
                              f"({len(gts)} annotated frames)")


if __name__ == "__main__":
    main()
