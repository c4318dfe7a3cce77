"""Cross-backend mask agreement: score one mask dir against another.

Checks device masks against the CPU path, e.g. at a non-square real CTC
geometry (690x628, Fluo-N2DH-SIM+ shape). bf16 accelerator matmuls vs f32
CPU are NOT bit-identical, so the honest check is an agreement SCORE: treat dir A's masks as ground truth
and SEG-score dir B's against them (symmetric mismatches shrink the
per-object Jaccard either way). 1.0 = label-map-identical instances.

Usage: python scripts/mask_agreement.py <dir_a> <dir_b>
Prints one line: agreement=<mean SEG> frames=<n>  (exit 1 on no overlap)
"""

from __future__ import annotations

import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lstm_unet_tpu.io.tiff import read_tiff
from lstm_unet_tpu.metrics import seg_measure_sequence


def main() -> int:
    dir_a, dir_b = sys.argv[1], sys.argv[2]
    gts, preds = [], []
    for pa in sorted(glob.glob(os.path.join(dir_a, "mask*.tif"))):
        pb = os.path.join(dir_b, os.path.basename(pa))
        if os.path.exists(pb):
            gts.append(read_tiff(pa))
            preds.append(read_tiff(pb))
    if not gts:
        print(f"agreement: no overlapping masks between {dir_a} and {dir_b}")
        return 1
    score = seg_measure_sequence(gts, preds)
    print(f"agreement={score:.4f} frames={len(gts)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
