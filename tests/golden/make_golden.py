"""Regenerate the golden checkpoint + expected masks (tests/test_golden.py).

Run from the repo root on the CPU backend:

    JAX_PLATFORMS=cpu python tests/golden/make_golden.py

Trains the tiny model deterministically on the synthetic sequence below,
saves the checkpoint under tests/golden/ckpt/ and the masks produced by the
full streaming-inference pipeline under tests/golden/masks/. The test
re-runs inference from the committed checkpoint and asserts bit-identical
masks — a regression net over model numerics, checkpoint format, and the
whole postprocess chain (SURVEY.md §4 "golden tests").
"""

import glob
import os
import shutil
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

from lstm_unet_tpu.config import CTCInferenceParams, CTCParams, tiny_net_kernel_params  # noqa: E402
from lstm_unet_tpu.engine.infer import run_inference  # noqa: E402
from lstm_unet_tpu.engine.train import Trainer  # noqa: E402
from lstm_unet_tpu.io.synthetic import write_ctc_dataset  # noqa: E402

# Frozen data recipe — test_golden.py regenerates the same sequence
DATA = dict(num_frames=8, height=32, width=32, num_cells=3, seed=123)


def main():
    work = tempfile.mkdtemp()
    root = os.path.join(work, "ctc")
    write_ctc_dataset(root, **DATA)

    p = CTCParams(
        root_data_dir=root,
        train_sequence_list=[("Synth-N2DH-SIM", "01")],
        crop_size=(32, 32), batch_size=2, unroll_len=3,
        net_kernel_params=tiny_net_kernel_params(), learning_rate=3e-3,
        dtype="float32",
        root_save_dir=work, experiment_name="Golden",
        print_to_console_interval=50, validation_interval=10**6,
        save_checkpoint_iteration=10**6, write_to_tb_interval=10**6)
    t = Trainer(p, seed=0)
    t.train(num_iterations=150)

    ckpt_dst = os.path.join(HERE, "ckpt")
    shutil.rmtree(ckpt_dst, ignore_errors=True)
    shutil.copytree(p.experiment_save_dir, ckpt_dst)

    masks_dst = os.path.join(HERE, "masks")
    shutil.rmtree(masks_dst, ignore_errors=True)
    ip = CTCInferenceParams(
        model_path=ckpt_dst,
        sequence_path=os.path.join(root, "Synth-N2DH-SIM", "01"),
        output_path=masks_dst, pre_sequence_frames=2, min_cell_size=5,
        dtype="float32")
    n = run_inference(ip)
    print(f"golden: {n} masks, ckpt at {ckpt_dst}")
    assert glob.glob(os.path.join(masks_dst, "mask*.tif"))


if __name__ == "__main__":
    main()
