"""bf16 LSTM-carry drift over a long stream (VERDICT r1 weak #6 / TODO #8).

The ConvLSTM cell state accumulates across an unbounded stream; under bf16
compute the carry can be kept in bf16 (state_dtype='auto') or f32
(state_dtype='float32'). This measures the actual divergence between the two
over a 1000+-frame stateful stream on the flagship model: per-frame max
|logits delta| and the instance-mask pixel disagreement, every K frames.

The stream concatenates many synthetic segments (different seeds) WITHOUT
state resets — scene changes stress the carry more than a quasi-static
field of drifting cells.

Usage (on the GPU):
    python scripts/carry_drift.py --model_path runs/<run>/ckpt \
        --frames 1200 --size 512
"""

from __future__ import annotations

import argparse
import time

import numpy as np

import jax
import jax.numpy as jnp


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_path", type=str, required=True)
    ap.add_argument("--frames", type=int, default=1200)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--segment", type=int, default=40,
                    help="frames per synthetic segment; state is NEVER "
                         "reset across segment boundaries")
    ap.add_argument("--velocity_scale", type=float, default=1.0,
                    help="cell drift per frame; with --segment == --frames "
                         "use ~0.2 so one coherent sequence keeps its cells "
                         "in frame for 1000+ frames")
    ap.add_argument("--report_every", type=int, default=100)
    ap.add_argument("--cells", type=int, default=30)
    args = ap.parse_args()

    from lstm_unet_tpu.engine.infer import load_model
    from lstm_unet_tpu.io.preprocess import percentile_normalize_np
    from lstm_unet_tpu.io.synthetic import make_cell_sequence
    from lstm_unet_tpu.models import ULSTMnet2D
    from lstm_unet_tpu.ops.postprocess import postprocess_frame

    runs = {}
    for state_dtype in ("auto", "float32"):
        params, cfg = load_model(args.model_path, dtype="bfloat16",
                                 state_dtype=state_dtype)
        from lstm_unet_tpu.models.ulstm_unet import cast_params_for_inference

        params = jax.device_put(
            cast_params_for_inference(params, cfg.compute_dtype))

        def step(params, state, frame, cfg=cfg):
            new_state, logits = ULSTMnet2D.step(params, state, frame, cfg)
            probs = jax.nn.softmax(logits[0], axis=-1)
            labels = postprocess_frame(probs, cell_thresh=0.5,
                                       edge_thresh=0.3, min_cell_size=10)
            return new_state, logits, labels

        jstep = jax.jit(step, donate_argnums=(1,))
        state = ULSTMnet2D.init_state(cfg, 1, args.size, args.size)
        runs[state_dtype] = (jstep, params, state)

    from lstm_unet_tpu.metrics import seg_measure

    n_seg = (args.frames + args.segment - 1) // args.segment
    t0 = time.perf_counter()
    # divergence alone doesn't pick a default (two chaotic-but-equal
    # variants also diverge) — score each variant against the generator's
    # instance GT so drift is measured as QUALITY, not distance
    print("frame,max_abs_dlogits,mask_diff_px,instances_bf16,instances_f32,"
          "seg_bf16,seg_f32")
    frame_idx = 0
    for seg in range(n_seg):
        imgs, gts = make_cell_sequence(num_frames=args.segment,
                                       height=args.size, width=args.size,
                                       num_cells=args.cells, seed=1000 + seg,
                                       velocity_scale=args.velocity_scale)
        for f, gt in zip(imgs, gts):
            x = jnp.asarray(percentile_normalize_np(f),
                            jnp.float32)[None, ..., None]
            out = {}
            for k, (jstep, params, state) in runs.items():
                new_state, logits, labels = jstep(params, state, x)
                runs[k] = (jstep, params, new_state)
                out[k] = (logits, labels)
            frame_idx += 1
            if frame_idx % args.report_every == 0 or frame_idx == args.frames:
                la, ma = out["auto"]
                lf, mf = out["float32"]
                dl = float(jnp.max(jnp.abs(la.astype(jnp.float32)
                                           - lf.astype(jnp.float32))))
                dm = int(jnp.sum((ma > 0) != (mf > 0)))
                ia = int(jnp.max(ma))
                if_ = int(jnp.max(mf))
                sa, na = seg_measure(np.asarray(gt), np.asarray(ma))
                sf, nf = seg_measure(np.asarray(gt), np.asarray(mf))
                sa = sa / max(na, 1)
                sf = sf / max(nf, 1)
                print(f"{frame_idx},{dl:.5f},{dm},{ia},{if_},"
                      f"{sa:.4f},{sf:.4f}", flush=True)
            if frame_idx >= args.frames:
                break
        if frame_idx >= args.frames:
            break
    dt = time.perf_counter() - t0
    print(f"# {frame_idx} frames x 2 variants in {dt:.1f}s")


if __name__ == "__main__":
    main()
