"""Profile the streaming-inference step and bucket device time by op class.

Buckets the traced device time into convs, fusions, converts, XLA-inserted
glue (pad/copy/reshape) and postprocess ops, so the glue budget of any
config can be read off one run.

Usage (on the GPU):
    python scripts/profile_stream.py [--dtype int8] [--calibrated] \
        [--frames 8] [--size 512]
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import tempfile
from collections import defaultdict


def bucket(name: str) -> str:
    n = name.lower()
    if "convolution" in n or "conv" in n and "convert" not in n:
        return "conv"
    if "fusion" in n:
        return "fusion"
    if "convert" in n:
        return "convert"
    if any(k in n for k in ("copy", "pad", "reshape", "transpose", "slice",
                            "broadcast", "concatenate")):
        return "copy/pad/reshape"
    if any(k in n for k in ("reduce", "scatter", "sort", "iota", "select",
                            "while", "dynamic", "gather", "cumsum", "and",
                            "add", "compare")):
        return "postprocess/other"
    return "other"


def device_op_self_times(data: dict):
    """(self_time_by_op_name, device_busy_us) from a jax.profiler trace.

    The device "XLA Ops" track is NESTED: a `while` op's span contains its
    body's fusion spans (and scan bodies contain whole sub-programs), so
    naively summing `dur` double-counts — a B5/T7 BPTT step traced 5.6 s of
    "op time" against 2.8 s of actual device busy time. A stack sweep per
    thread assigns each span its EXCLUSIVE (self) time: dur minus the time
    covered by spans nested inside it. Exclusive times sum to device busy
    time, so buckets are honest fractions of the step.
    """
    meta = [e for e in data.get("traceEvents", []) if e.get("ph") == "M"]
    dev_pids = {e["pid"] for e in meta
                if e.get("name") == "process_name"
                and "/device:GPU" in str(e["args"].get("name", ""))}
    tname = {(e["pid"], e.get("tid")): str(e["args"].get("name", ""))
             for e in meta if e.get("name") == "thread_name"}

    by_tid = defaultdict(list)
    steps_total = 0.0
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        # no GPU device track (CPU-backend run, renamed runtime): fall
        # back to sweeping every track rather than reporting zeros
        if dev_pids and e["pid"] not in dev_pids:
            continue
        name = tname.get((e["pid"], e.get("tid")), "")
        if name == "Steps":
            steps_total += e["dur"]
            continue
        if name == "XLA Modules":  # whole-program parents of every op
            continue
        by_tid[(e["pid"], e.get("tid"))].append(e)

    self_by_name = defaultdict(float)
    busy = 0.0
    for events in by_tid.values():
        # parents sort before their children: earlier start, then longer
        events.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # (end_ts, name, remaining_self)
        for e in events:
            ts, dur = e["ts"], e["dur"]
            while stack and stack[-1][0] <= ts + 1e-9:
                end, nm, self_t = stack.pop()
                self_by_name[nm] += self_t
                busy += self_t
            if stack:  # nested: parent loses this span's duration
                stack[-1][2] -= dur
            stack.append([ts + dur, e.get("name", ""), dur])
        while stack:
            end, nm, self_t = stack.pop()
            self_by_name[nm] += self_t
            busy += self_t
    return self_by_name, busy, steps_total


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dtype", type=str, default="int8")
    ap.add_argument("--calibrated", action="store_true", default=True)
    ap.add_argument("--no-calibrated", dest="calibrated", action="store_false")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--mode", choices=["infer", "train"], default="infer",
                    help="train: profile the BPTT step (B5/T7, remat)")
    ap.add_argument("--remat_policy", type=str, default="full",
                    choices=["full", "save_outputs", "none"])
    ap.add_argument("--conv_method", type=str, default="conv",
                    choices=["conv", "dots", "auto"],
                    help="float conv lowering (ops/conv.py A/B)")
    ap.add_argument("--int8_conv", type=str, default="conv",
                    choices=["conv", "dots", "auto"],
                    help="int8 conv lowering (ops/quant.py A/B)")
    ap.add_argument("--entry_layouts", action="store_true",
                    help="AUTO entry layouts for the weights (bench.py A/B)")
    ap.add_argument("--ccl", type=str, default="sweep",
                    choices=["sweep", "scan"])
    args = ap.parse_args()

    if args.conv_method != "conv":
        from lstm_unet_tpu.ops import conv as conv_mod

        conv_mod.CONV_METHOD = args.conv_method
    if args.int8_conv != "conv":
        from lstm_unet_tpu.ops import quant

        quant.INT8_CONV_METHOD = args.int8_conv

    import jax
    import jax.numpy as jnp

    import bench

    tmp = tempfile.mkdtemp(prefix="trace_")
    if args.mode == "train":
        # warm-up + traced steps inside bench_train is awkward; inline the
        # same setup here with an explicit trace window
        import numpy as np
        import optax

        from lstm_unet_tpu.config import default_net_kernel_params
        from lstm_unet_tpu.engine.train import make_train_step
        from lstm_unet_tpu.models import ModelConfig, ULSTMnet2D

        size = 256 if args.size == 512 else args.size
        cfg = ModelConfig.make(default_net_kernel_params(),
                               dtype="bfloat16" if args.dtype == "int8"
                               else args.dtype)
        params = ULSTMnet2D.init(jax.random.PRNGKey(0), cfg)
        opt = optax.adam(1e-4)
        opt_state = opt.init(params)
        remat = {"full": True, "none": False}.get(args.remat_policy,
                                                  args.remat_policy)
        step = make_train_step(cfg, opt, (0.15, 0.25, 0.6), remat=remat)
        B, T = 5, 7
        state = ULSTMnet2D.init_state(cfg, B, size, size)
        img = jnp.zeros((B, T, size, size, 1), jnp.float32) + 0.5
        seg = jnp.zeros((B, T, size, size), jnp.int32)
        ones = jnp.ones((B, T))
        last = jnp.zeros((B,))
        params, opt_state, state, m = step(params, opt_state, state, img,
                                           seg, ones, ones, last)
        jax.block_until_ready(m)
        args.frames = max(args.frames // 4, 2)  # train steps are heavy
        jax.profiler.start_trace(tmp)
        for _ in range(args.frames):
            params, opt_state, state, m = step(params, opt_state, state,
                                               img, seg, ones, ones, last)
        jax.block_until_ready((params, m))
        jax.profiler.stop_trace()
    else:
        fn, params, state = bench.build_pipeline(
            args.size, args.dtype, tiny=False, calibrated=args.calibrated,
            ccl_method=args.ccl, entry_layouts=args.entry_layouts)
        frames = bench.make_frames(4, args.size)
        dev = [jax.device_put(jnp.asarray(f)) for f in frames]
        state, labels = fn(params, state, dev[0])
        jax.block_until_ready(labels)

        jax.profiler.start_trace(tmp)
        for i in range(args.frames):
            state, labels = fn(params, state, dev[i % len(dev)])
        jax.block_until_ready((state, labels))
        jax.profiler.stop_trace()

    traces = glob.glob(os.path.join(tmp, "**", "*.trace.json.gz"),
                       recursive=True)
    if not traces:
        raise SystemExit(f"no trace files under {tmp}")
    with gzip.open(traces[0], "rt") as f:
        data = json.load(f)

    # device-lane events, EXCLUSIVE time (nested spans de-duplicated)
    by_name, busy, steps_total = device_op_self_times(data)
    by_bucket = defaultdict(float)
    for n, t in by_name.items():
        by_bucket[bucket(n)] += t
    total = busy  # == sum of buckets by construction
    unit = "step" if args.mode == "train" else "frame"
    print(f"device busy {total / 1e3:.2f} ms over {args.frames} {unit}s "
          f"= {total / args.frames / 1e3:.2f} ms/{unit}"
          + (f" (Steps track: {steps_total / args.frames / 1e3:.2f} "
             f"ms/{unit})" if steps_total else ""))
    for b, t in sorted(by_bucket.items(), key=lambda kv: -kv[1]):
        print(f"  {b:20s} {t / args.frames / 1e3:7.2f} ms/frame "
              f"({100 * t / total:4.1f}%)")
    print("top ops:")
    for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {t / args.frames / 1e3:7.2f} ms/frame  {n[:100]}")


if __name__ == "__main__":
    main()
