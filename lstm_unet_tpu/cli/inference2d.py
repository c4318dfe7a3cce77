"""Inference CLI.

Reference parity: ``python Inference2D.py --model_path … --sequence_path …
--output_path …`` (SURVEY.md §1 L3, §3.2). Flags map onto
``CTCInferenceParams`` fields of the same name.

Usage:
    python -m lstm_unet_tpu.cli.inference2d --model_path runs/X/ckpt \
        --sequence_path data/Fluo-N2DH-SIM+/01 --output_path out/01_RES
"""

from __future__ import annotations

import argparse

from ..config import CTCInferenceParams
from ..engine.infer import run_inference
from ..utils.compile_cache import enable_compile_cache


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_path", type=str, required=True)
    ap.add_argument("--sequence_path", type=str, required=True)
    ap.add_argument("--output_path", type=str, required=True)
    ap.add_argument("--filename_format", type=str)
    ap.add_argument("--FOV", type=int)
    ap.add_argument("--min_cell_size", type=int)
    ap.add_argument("--max_cell_size", type=int)
    ap.add_argument("--cell_thresh", type=float)
    ap.add_argument("--edge_thresh", type=float)
    ap.add_argument("--boundary_growth", type=str,
                    choices=["marker", "dilate", "none"])
    ap.add_argument("--grow_iters", type=int)
    ap.add_argument("--size_filter", type=str, default=None,
                    choices=("pre", "post"),
                    help="'post' measures min/max_cell_size on the GROWN "
                         "extent (crescents with tiny interiors survive)")
    ap.add_argument("--conv_method", type=str,
                    choices=["conv", "dots", "auto"],
                    help="conv lowering (ops/conv.py + int8 twin)")
    ap.add_argument("--entry_layouts", action="store_true", default=None,
                    help="AOT step with AUTO entry layouts for the weights "
                         "(one-time relayout instead of per-frame conv-"
                         "kernel copies; single-device)")
    ap.add_argument("--tta", action="store_true", default=None,
                    help="flip test-time augmentation: average softmax "
                         "probs over the 4 flip variants (4x compute)")
    ap.add_argument("--tta_mode", type=str, default=None,
                    choices=("flip", "d4"),
                    help="'d4' adds the 4 transposed variants (full "
                         "dihedral group, 8x compute, pads square)")
    ap.add_argument("--instance_split", action="store_true", default=None,
                    help="split merged components of touching cells "
                         "(see --split_method)")
    ap.add_argument("--split_method", type=str, choices=("dist", "prob"),
                    help="'dist' = distance-ridge markers, 'prob' = "
                         "hysteresis markers from p(cell) dips")
    ap.add_argument("--split_hi_thresh", type=float)
    ap.add_argument("--split_erode", type=int)
    ap.add_argument("--split_window", type=int)
    ap.add_argument("--split_min_dist", type=int)
    ap.add_argument("--split_slack", type=int)
    ap.add_argument("--split_rel", type=float)
    ap.add_argument("--split_rel_window", type=int)
    ap.add_argument("--split_min_size", type=int)
    ap.add_argument("--pre_sequence_frames", type=int)
    ap.add_argument("--save_intermediate", action="store_true", default=None)
    ap.add_argument("--save_intermediate_path", type=str)
    ap.add_argument("--int8_keep_float", type=str, default=None,
                    help="comma-separated site prefixes kept bf16 inside an "
                         "int8 run (mixed precision, e.g. 'encoder/0')")
    ap.add_argument("--dtype", type=str,
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--state_dtype", type=str,
                    choices=["auto", "float32", "bfloat16"])
    ap.add_argument("--digit_4", action="store_true", default=None)
    ap.add_argument("--reset_on_jump", type=float,
                    help="auto-reset LSTM state when the mean abs frame "
                         "delta exceeds this (0/off = reference behavior)")
    ap.add_argument("--calibrate", type=int, default=None, metavar="N",
                    help="first calibrate int8 activation scales on the "
                         "sequence's first N frames (writes act_scales.json "
                         "into --model_path; later int8 runs reuse it)")
    ap.add_argument("--watchdog_secs", type=float, default=None,
                    help="exit 17 if no inference frame completes for this "
                         "many seconds (wedged device client); 0 disables. "
                         "Must cover the first-step compile.")
    ap.add_argument("--recipe", type=str, default=None,
                    help="knob recipe JSON (configs/recommended.json or a "
                         "scripts/calibrate_recipe.py output); explicit "
                         "flags still win over recipe keys")
    ap.add_argument("--ckpt_step", type=int,
                    help="restore this saved checkpoint step (0 = latest)")
    return ap


def main(argv=None) -> None:
    args = vars(build_parser().parse_args(argv))
    enable_compile_cache()
    calibrate = args.pop("calibrate")
    recipe = args.pop("recipe")
    params = CTCInferenceParams()
    if recipe:
        from ..config import load_recipe

        params.override(**load_recipe(recipe, known=set(vars(params))))
    params.override(**args)
    if calibrate:
        from ..engine.infer import calibrate_model_dir

        calibrate_model_dir(params.model_path, params.sequence_path,
                            n_frames=calibrate,
                            filename_format=params.filename_format,
                            step=params.ckpt_step or None)
    run_inference(params)


if __name__ == "__main__":
    main()
