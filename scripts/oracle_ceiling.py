"""Postprocess-oracle ceiling for the held-out protocol (VERDICT r2 task #1).

The oracle feeds GT-DERIVED 3-class probabilities (instance GT ->
instance_to_three_class -> one-hot) through the SAME on-device postprocess
chain the model uses (threshold -> CCL -> optional instance_split -> size
filter -> boundary growth) and scores SEG against the instance GT. That is
the quality ceiling set by the data + postprocess alone — the model can
never beat it, so raising it (instance_split) raises what training can
reach. BASELINE.md r2 measured 0.917 WITHOUT splitting.

Usage:
    python scripts/oracle_ceiling.py --root /tmp/heldout_v3/eval \
        [--instance_split] [--split_window 8] [--split_min_dist 4] \
        [--min_cell_size 50]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

import jax
import jax.numpy as jnp

from lstm_unet_tpu.io.preprocess import instance_to_three_class
from lstm_unet_tpu.io.tiff import read_tiff
from lstm_unet_tpu.metrics import seg_measure_sequence
from lstm_unet_tpu.ops.postprocess import postprocess_frame


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", type=str, required=True,
                    help="eval root with <ds>/<seq>_GT/SEG dirs")
    ap.add_argument("--min_cell_size", type=int, default=50)
    ap.add_argument("--instance_split", action="store_true")
    ap.add_argument("--split_window", type=int, default=16)
    ap.add_argument("--split_min_dist", type=int, default=4)
    ap.add_argument("--split_slack", type=int, default=1)
    ap.add_argument("--split_rel", type=float, default=0.65)
    ap.add_argument("--split_rel_window", type=int, default=48)
    ap.add_argument("--split_min_size", type=int, default=0)
    ap.add_argument("--size_filter", type=str, default="pre",
                    choices=("pre", "post"),
                    help="'post' measures min_cell_size on the GROWN "
                         "extent (absorbed-crescent rescue)")
    ap.add_argument("--max_frames", type=int, default=0)
    args = ap.parse_args()

    seg_dirs = sorted(glob.glob(os.path.join(args.root, "*", "*_GT", "SEG")))
    if not seg_dirs:
        raise FileNotFoundError(f"no *_GT/SEG under {args.root}")
    means = []
    for seg_dir in seg_dirs:
        gts, preds = [], []
        files = sorted(glob.glob(os.path.join(seg_dir, "man_seg*.tif")))
        if args.max_frames:
            files = files[: args.max_frames]
        for f in files:
            gt = read_tiff(f)
            three = instance_to_three_class(gt)
            probs = np.eye(3, dtype=np.float32)[three]
            lab = postprocess_frame(
                jnp.asarray(probs), min_cell_size=args.min_cell_size,
                size_filter=args.size_filter,
                instance_split=args.instance_split,
                split_window=args.split_window,
                split_min_dist=args.split_min_dist,
                split_slack=args.split_slack, split_rel=args.split_rel,
                split_rel_window=args.split_rel_window,
                split_min_size=args.split_min_size)
            gts.append(gt)
            preds.append(np.asarray(lab))
        score = seg_measure_sequence(gts, preds)
        means.append(score)
        print(f"{seg_dir}: oracle SEG {score:.4f} ({len(gts)} frames)")
    print(f"mean oracle SEG: {float(np.mean(means)):.4f} "
          f"(split={args.instance_split} window={args.split_window} "
          f"min_dist={args.split_min_dist} slack={args.split_slack} "
          f"rel={args.split_rel}/{args.split_rel_window} "
          f"min_size={args.split_min_size} min_cell={args.min_cell_size} "
          f"sf={args.size_filter})")


if __name__ == "__main__":
    main()
