"""Training CLI.

Reference parity: ``python train2D.py [overrides]`` (SURVEY.md §1 L3) —
argparse overrides mutate a ``CTCParams`` instance. Same contract here:
every flag maps onto a ``CTCParams`` field of the same name.

Usage:
    python -m lstm_unet_tpu.cli.train2d --root_data_dir ./data \
        --num_iterations 10000 --batch_size 5 --unroll_len 7
"""

from __future__ import annotations

import argparse
import json

from ..config import CTCParams, NetKernelParams
from ..engine.train import Trainer
from ..utils import log_print
from ..utils.compile_cache import enable_compile_cache


def _parse_seq_list(s: str):
    # "Fluo-N2DH-SIM+:01,Fluo-N2DH-SIM+:02"
    out = []
    for item in s.split(","):
        ds, seq = item.rsplit(":", 1)
        out.append((ds, seq))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--experiment_name", type=str)
    ap.add_argument("--root_save_dir", type=str)
    ap.add_argument("--root_data_dir", type=str)
    ap.add_argument("--train_sequence_list", type=_parse_seq_list,
                    help="e.g. 'Fluo-N2DH-SIM+:01,Fluo-N2DH-SIM+:02'")
    ap.add_argument("--val_sequence_list", type=_parse_seq_list)
    ap.add_argument("--crop_size", type=int, nargs=2)
    ap.add_argument("--batch_size", type=int)
    ap.add_argument("--unroll_len", type=int)
    ap.add_argument("--learning_rate", type=float)
    ap.add_argument("--grad_clip_norm", type=float)
    ap.add_argument("--num_iterations", type=int)
    ap.add_argument("--class_weights", type=float, nargs=3)
    ap.add_argument("--net_kernel_params", type=str,
                    help="JSON file or inline JSON with the architecture")
    ap.add_argument("--validation_interval", type=int)
    ap.add_argument("--print_to_console_interval", type=int)
    ap.add_argument("--save_checkpoint_iteration", type=int)
    ap.add_argument("--write_to_tb_interval", type=int)
    ap.add_argument("--load_checkpoint", action="store_true", default=None)
    ap.add_argument("--load_checkpoint_path", type=str)
    ap.add_argument("--continue_run", action="store_true", default=None)
    ap.add_argument("--dry_run", action="store_true", default=None)
    ap.add_argument("--profile", action="store_true", default=None)
    ap.add_argument("--watchdog_secs", type=float,
                    help="exit 17 if no train step completes for this many "
                         "seconds (wedged device client); 0 disables. A "
                         "supervisor relaunches with --continue_run.")
    ap.add_argument("--spike_factor", type=float,
                    help="roll back to the last checkpoint when train loss "
                         "exceeds this factor x its EMA (finite-spike "
                         "damage guard); 0 disables")
    ap.add_argument("--spike_cooldown", type=int)
    ap.add_argument("--spike_max_rollbacks", type=int)
    ap.add_argument("--rss_relaunch_gb", type=float,
                    help="save + exit 17 when host VmRSS exceeds this many "
                         "GB, for a supervisor relaunch with --continue_run. "
                         "0 (default) disables.")
    ap.add_argument("--compact_upload", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="bit-identical compact batch uploads (int8 labels "
                         "+ host-side bf16 image pre-cast, ~2.7x fewer "
                         "uploaded bytes; default on)")
    ap.add_argument("--dtype", type=str, choices=["float32", "bfloat16"])
    ap.add_argument("--adam_mu_dtype", type=str,
                    choices=["float32", "bfloat16"],
                    help="Adam first-moment storage dtype (bfloat16 halves "
                         "mu bytes + per-step copy traffic; nu stays f32)")
    ap.add_argument("--remat", action="store_true", default=None)
    ap.add_argument("--remat_policy", type=str,
                    choices=["full", "save_outputs"])
    ap.add_argument("--conv_method", type=str,
                    choices=["conv", "dots", "auto"],
                    help="conv lowering (ops/conv.py): 'dots' = shifted-tap "
                         "matmuls, no conv layout copies in fwd/BPTT")
    ap.add_argument("--entry_layouts", action="store_true", default=None,
                    help="AOT train step with AUTO entry/exit layouts for "
                         "params/opt_state/state (one-time relayout instead "
                         "of per-step conv-kernel copies; single-device)")
    ap.add_argument("--gt_is_full_seg", type=lambda s: s.lower() == "true",
                    default=None, help="override the full-annotation heuristic")
    ap.add_argument("--data_provider_class", type=str,
                    choices=["CTCRAMReaderSequence2D",
                             "GrainCTCReaderSequence2D"],
                    help="training reader (engine.train.DATA_PROVIDERS): the "
                         "threaded per-lane queue reader (reference parity) "
                         "or the deterministic grain pipeline whose "
                         "batch(step) is a pure function of (seed, step) — "
                         "watchdog/OOM relaunches REPLAY the stream instead "
                         "of restarting the traversal schedule")
    ap.add_argument("--recipe", type=str, default=None,
                    help="knob recipe JSON (configs/recommended.json); "
                         "training keys it carries (e.g. class_weights) "
                         "apply before explicit flags")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> None:
    args = vars(build_parser().parse_args(argv))
    enable_compile_cache()
    seed = args.pop("seed")
    recipe = args.pop("recipe", None)
    nkp = args.pop("net_kernel_params", None)
    params = CTCParams()
    if recipe:
        from ..config import load_recipe

        params.override(**load_recipe(recipe, known=set(vars(params))))
    if nkp:
        try:
            d = json.loads(nkp)
        except json.JSONDecodeError:
            with open(nkp) as f:
                d = json.load(f)
        params.net_kernel_params = NetKernelParams.from_dict(d)
    if args.get("crop_size"):
        args["crop_size"] = tuple(args["crop_size"])
    if args.get("class_weights"):
        args["class_weights"] = tuple(args["class_weights"])
    params.override(**args)
    # dir resolution is the Trainer's job: for continue_run WITHOUT an
    # explicit load path it must reuse the latest matching experiment dir —
    # resolving a fresh timestamped dir here would leave no checkpoint for
    # _restore
    trainer = Trainer(params, seed=seed)
    log_print(f"training: save_dir={params.experiment_save_dir}")
    trainer.train()


if __name__ == "__main__":
    main()
