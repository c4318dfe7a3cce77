"""Checkpoint selection + durable best-model artifact (pipeline stage 5).

Closes two round-3 gaps (VERDICT r3 tasks 4+7):

- **Selection is a tested pipeline stage, not lore.** val/seg rank-inverted
  against held-out SEG twice in round 3 (4000>5000>6000 reversed; a
  "recovered" val 0.9419 checkpoint scored 0.8549 held-out), and the
  measured remedies — rank late saves on a WIDER val set, soup the best
  two — lived only in BASELINE.md + a manual CLI. This script ranks the
  last N saved checkpoints on >=2 val sequences (default 03 = the crop-val
  sequence, 10 = a v4 sequence unseen by v3bw training; eval/ stays
  untouched by selection), averages the best two (checkpoint soup,
  cli/ckpt_avg machinery), and confirms the soup ONCE on the held-out eval
  split. Ranking never looks at eval; eval is only used to report the
  pre-registered winner, so the protocol stays selection-clean.

- **A VM reset must cost zero reproduction hours.** Round 3 lost the
  headline checkpoint to /tmp wipes twice. The soup is written to
  ``--best_dir`` (runs/save/best) as a STANDALONE inference model dir
  (params-only step ckpt + model_params.json + the recipe JSON + int8
  act_scales after calibration) served directly by
  ``inference2d --model_path runs/save/best``. ``--prune`` then removes
  stale step dirs from the training run (keeps the soup constituents + the
  latest), bounding runs/save growth (~0.9 GB per step dir).

Device cost: len(steps) val sweeps + 1-2 eval confirms, each a
``ctc_sweep`` child process started one at a time (this parent never opens
the device; checkpoint averaging is numpy-only).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG_RE = re.compile(r"SEG (\S+): ([0-9.]+)")
DET_RE = re.compile(r"DET (\S+): ([0-9.]+)")


def _sweep_fingerprint(model_path: str, recipe: str, ckpt_step: int,
                       dtype: str, calibrate: int) -> dict:
    """Identity of the inputs a cached sweep's scores depend on.

    ADVICE r4 (medium): the cache used to be keyed on the output dir alone,
    so a stage that deliberately re-runs with a NEW recipe (11e recalibrated
    v4ft selection) or refreshed weights at the same step silently got the
    OLD recipe's scores back. The recipe is hashed by content (calibration
    outputs are regenerated at the same path); the model by path + step
    (step dirs are immutable once written — a rebuilt soup changes the
    constituents tag in the work-dir name instead).
    """
    recipe_sha = ""
    if recipe:
        with open(recipe, "rb") as f:
            recipe_sha = hashlib.sha256(f.read()).hexdigest()[:16]
    return {"model_path": os.path.abspath(model_path),
            "recipe_sha": recipe_sha, "ckpt_step": ckpt_step,
            "dtype": dtype, "calibrate": calibrate}


def run_sweep(model_path: str, data_root: str, output_root: str,
              recipe: str, seqs: str = "", ckpt_step: int = 0,
              dtype: str = "", calibrate: int = 0,
              timeout: int = 2700) -> dict:
    """One ctc_sweep subprocess; returns {"seg": {seq: SEG}, "det": {seq: DET}}.

    Scores are cached in <output_root>/seg_scores.json: rerunning after an
    interrupted stage skips sweeps that already completed instead of paying
    their device time again.
    The cache carries a fingerprint of (model, recipe content, step, dtype,
    calibrate); a mismatch — or a legacy fingerprint-less cache — re-runs
    the sweep instead of returning scores from different inputs.
    """
    fp = _sweep_fingerprint(model_path, recipe, ckpt_step, dtype, calibrate)
    cache = os.path.join(output_root, "seg_scores.json")
    if os.path.exists(cache):
        with open(cache) as f:
            cached = json.load(f)
        if (isinstance(cached, dict) and cached.get("fingerprint") == fp
                and cached.get("seg")):
            print(f"select_best: cached scores for {output_root}", flush=True)
            return {"seg": cached["seg"], "det": cached.get("det", {})}
        print(f"select_best: STALE cache for {output_root} "
              "(fingerprint mismatch or legacy format) — re-running",
              flush=True)
    cmd = [sys.executable, "-m", "lstm_unet_tpu.cli.ctc_sweep",
           "--model_path", model_path, "--root_data_dir", data_root,
           "--output_root", output_root, "--score_seg", "--score_det",
           "--watchdog_secs", "600"]
    if recipe:
        cmd += ["--recipe", recipe]
    if seqs:
        cmd += ["--seqs", seqs]
    if ckpt_step:
        cmd += ["--ckpt_step", str(ckpt_step)]
    if dtype:
        cmd += ["--dtype", dtype]
    if calibrate:
        cmd += ["--calibrate", str(calibrate)]
    r = subprocess.run(cmd, text=True, capture_output=True, timeout=timeout,
                       cwd=REPO)
    sys.stderr.write(r.stdout[-2000:] + r.stderr[-1000:])
    if r.returncode != 0:
        raise RuntimeError(f"ctc_sweep rc={r.returncode}: {' '.join(cmd)}")
    scores = {"seg": {m.group(1): float(m.group(2))
                      for m in SEG_RE.finditer(r.stdout)},
              "det": {m.group(1): float(m.group(2))
                      for m in DET_RE.finditer(r.stdout)}}
    if scores["seg"]:
        os.makedirs(output_root, exist_ok=True)
        with open(cache, "w") as f:
            json.dump({"fingerprint": fp, **scores}, f)
    return scores


def kendall_tau(pairs):
    """Kendall tau-a between two paired score lists.

    ``pairs`` = [(a_i, b_i), ...]; returns (tau, concordant, discordant).
    Tau-a divides by ALL n(n-1)/2 pairs, so ties lower the score instead of
    being dropped (ADVICE r4: the previous (C-D)/(C+D) was Goodman-Kruskal
    gamma, which overstates agreement under ties). +1 = identical ordering,
    -1 = fully inverted — the round-3 val-rank inversions would have shown
    tau <= 0 here.
    """
    conc = disc = 0
    n = len(pairs)
    for i in range(n):
        for j in range(i + 1, n):
            s = (pairs[i][0] - pairs[j][0]) * (pairs[i][1] - pairs[j][1])
            conc += s > 0
            disc += s < 0
    return (conc - disc) / max(n * (n - 1) // 2, 1), conc, disc


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_path", required=True,
                    help="training run dir (or its ckpt/ subdir)")
    ap.add_argument("--data_root", required=True,
                    help="held-out protocol root (train/ = val source, "
                         "eval/ = confirm-only)")
    ap.add_argument("--val_seqs", default="03,10",
                    help="ranking sequences under <data_root>/train "
                         "(NEVER in eval/)")
    ap.add_argument("--steps", default="",
                    help="comma-separated checkpoint steps to rank "
                         "(default: the last --last_n saved)")
    ap.add_argument("--last_n", type=int, default=4)
    ap.add_argument("--recipe", default="",
                    help="postprocess recipe JSON for every sweep")
    ap.add_argument("--best_dir", default="",
                    help="write soup(best two) here as a standalone durable "
                         "inference model dir")
    ap.add_argument("--prune", action="store_true",
                    help="after the soup is written, delete step dirs other "
                         "than the soup constituents + the latest")
    ap.add_argument("--skip_int8", action="store_true",
                    help="skip the int8 calibration + parity confirm on the "
                         "soup")
    ap.add_argument("--eval_rank", action="store_true",
                    help="DIAGNOSTIC: also score every ranked step on eval/ "
                         "and log the val-vs-eval rank agreement (Kendall "
                         "tau). Selection never uses these scores (the soup "
                         "is chosen before they exist) but the agreement "
                         "number quantifies how trustworthy val ranking is "
                         "(it rank-inverted twice in round 3). Costs one "
                         "eval sweep per ranked step.")
    ap.add_argument("--work_dir", default="",
                    help="where sweep masks land (default "
                         "<model_path>/select_best_work)")
    ap.add_argument("--out", default="", help="summary JSON path")
    args = ap.parse_args()

    from lstm_unet_tpu.checkpoint import average_checkpoints, resolve_model_dir

    ckpt_dir = resolve_model_dir(args.model_path)
    saved = sorted(int(d) for d in os.listdir(ckpt_dir)
                   if d.isdigit() and os.path.isdir(os.path.join(ckpt_dir, d)))
    if not saved:
        raise FileNotFoundError(f"no checkpoint steps under {ckpt_dir}")
    steps = ([int(s) for s in args.steps.split(",") if s.strip()]
             or saved[-args.last_n:])
    work = args.work_dir or os.path.join(args.model_path, "select_best_work")
    os.makedirs(work, exist_ok=True)

    # --- rank on val ------------------------------------------------------
    # One ctc_sweep SUBPROCESS per step, one at a time (one process per
    # device): each pays a model compile (the persistent compile cache
    # shortens repeats), but keeps per-subprocess watchdog isolation (a
    # wedged device client kills one sweep, not the whole selection) and
    # .ok-free resumability via the seg_scores.json cache — the deliberate
    # tradeoff vs restoring steps inside one compiled process.
    n_val = len([s for s in args.val_seqs.split(",") if s.strip()])
    ranking = []
    for s in steps:
        sw = run_sweep(args.model_path, os.path.join(args.data_root, "train"),
                       os.path.join(work, f"val_{s}"), args.recipe,
                       seqs=args.val_seqs, ckpt_step=s)
        scores = sw["seg"]
        if len(scores) != n_val:
            # A missing sequence/GT must not silently shrink the val set:
            # single-sequence ranking is exactly the round-3 inversion
            # this stage exists to avoid.
            raise RuntimeError(
                f"step {s}: {len(scores)} SEG scores for {n_val} requested "
                f"val sequences ({args.val_seqs}) — got {sorted(scores)}")
        mean = sum(scores.values()) / len(scores)
        row = {"step": s, "val_mean": round(mean, 4),
               "per_seq": {k: round(v, 4) for k, v in scores.items()}}
        if sw["det"]:
            # DET rides along as the second selection signal (VERDICT r4
            # #6): recorded next to SEG so SEG-vs-DET disagreement is
            # visible wherever ranking decisions are audited. Ranking stays
            # on SEG until a recorded disagreement shows DET catching an
            # inversion SEG missed.
            row["val_det_mean"] = round(
                sum(sw["det"].values()) / len(sw["det"]), 4)
            row["per_seq_det"] = {k: round(v, 4)
                                  for k, v in sw["det"].items()}
        ranking.append(row)
        print(f"select_best: step {s} val mean {mean:.4f}"
              + (f" det {row['val_det_mean']:.4f}" if sw["det"] else ""),
              flush=True)
    ranking.sort(key=lambda r: -r["val_mean"])
    best_two = sorted(r["step"] for r in ranking[:2])

    summary = {"val_ranking": ranking, "soup_steps": best_two}
    det_pairs = [(r["val_mean"], r["val_det_mean"])
                 for r in ranking if "val_det_mean" in r]
    if len(det_pairs) == len(ranking) and len(ranking) > 1:
        tau_sd, _, _ = kendall_tau(det_pairs)
        summary["val_seg_det_tau"] = round(tau_sd, 3)
        print(f"select_best: val SEG-vs-DET Kendall tau = {tau_sd:+.3f}",
              flush=True)

    # --- diagnostic: val-vs-eval rank agreement (soup already chosen) ------
    if args.eval_rank:
        for r in ranking:
            es = run_sweep(args.model_path,
                           os.path.join(args.data_root, "eval"),
                           os.path.join(work, f"evalrank_{r['step']}"),
                           args.recipe, ckpt_step=r["step"])["seg"]
            if not es:
                raise RuntimeError(f"eval_rank step {r['step']}: no SEG "
                                   "scores parsed — refusing to record 0.0")
            r["eval_mean"] = round(sum(es.values()) / len(es), 4)
            print(f"select_best: step {r['step']} eval mean "
                  f"{r['eval_mean']:.4f} (val {r['val_mean']:.4f})",
                  flush=True)
        tau, conc, disc = kendall_tau(
            [(r["val_mean"], r["eval_mean"]) for r in ranking])
        summary["rank_agreement_tau"] = round(tau, 3)
        print(f"select_best: val-vs-eval Kendall tau = {tau:+.3f} "
              f"({conc} concordant / {disc} discordant pairs)", flush=True)

    # --- soup + durable artifact ------------------------------------------
    if args.best_dir:
        # Build into a sibling tmp dir and swap ONLY after the soup,
        # recipe, provenance, eval confirm and int8 calibration all
        # succeeded: a crash/preemption mid-stage must never destroy the
        # previous durable artifact (the one thing this stage exists to
        # preserve across VM resets).
        build = args.best_dir.rstrip("/") + ".tmp"
        if os.path.isdir(build):
            shutil.rmtree(build)
        out_step = average_checkpoints(args.model_path, build,
                                       steps=best_two)
        chosen = list(best_two)
        # Transient guard (r4 stage-9 lesson, measured: soup(8500,9000) of a
        # mid-transient fine-tune evaled 0.5514 vs 0.6895 for its best
        # single step): averaging assumes a CONVERGED tail. Check the soup
        # on the SAME val sequences the ranking used and fall back to the
        # best single step when averaging loses — a pre-registered val
        # decision, never an eval one.
        if len(best_two) > 1:
            sv = run_sweep(build, os.path.join(args.data_root, "train"),
                           os.path.join(work, "val_soup_"
                                        + "_".join(map(str, best_two))),
                           args.recipe, seqs=args.val_seqs)["seg"]
            if not sv:
                raise RuntimeError("soup val sweep parsed no SEG scores — "
                                   "refusing to gate on 0.0")
            soup_val = sum(sv.values()) / len(sv)
            summary["val_soup_mean"] = round(soup_val, 4)
            if soup_val < ranking[0]["val_mean"]:
                print(f"select_best: soup{best_two} val {soup_val:.4f} < "
                      f"best single step {ranking[0]['step']} val "
                      f"{ranking[0]['val_mean']:.4f} — shipping the single "
                      "step (transient tail: do not average)", flush=True)
                chosen = [ranking[0]["step"]]
                shutil.rmtree(build)
                out_step = average_checkpoints(args.model_path, build,
                                               steps=chosen)
        summary["artifact_steps"] = chosen
        summary["best_dir"] = args.best_dir
        summary["best_step"] = out_step
        if args.recipe:
            shutil.copyfile(args.recipe, os.path.join(build, "recipe.json"))
        with open(os.path.join(build, "provenance.json"), "w") as f:
            json.dump({"source": os.path.abspath(args.model_path),
                       "soup_steps": chosen,
                       "val_seqs": args.val_seqs,
                       "val_ranking": ranking}, f, indent=1)

        # confirm ONCE on eval (pre-registered winner — no eval ranking)
        soup_tag = "_".join(map(str, chosen))  # cache key tracks the soup
        soup_sw = run_sweep(build,
                            os.path.join(args.data_root, "eval"),
                            os.path.join(work, f"eval_soup_{soup_tag}"),
                            args.recipe)
        eval_scores = soup_sw["seg"]
        if not eval_scores:
            raise RuntimeError("soup eval confirm parsed no SEG scores "
                               "(eval GT missing?) — refusing to record 0.0")
        summary["eval_soup_mean"] = round(
            sum(eval_scores.values()) / len(eval_scores), 4)
        summary["eval_soup_per_seq"] = {
            k: round(v, 4) for k, v in eval_scores.items()}
        if soup_sw["det"]:
            summary["eval_soup_det_mean"] = round(
                sum(soup_sw["det"].values()) / len(soup_sw["det"]), 4)
        print(f"select_best: artifact{chosen} eval mean "
              f"{summary['eval_soup_mean']:.4f}", flush=True)

        if not args.skip_int8:
            # int8 gate on the soup; --calibrate also writes provenance-
            # stamped act_scales.json INTO the build dir (soups must
            # recalibrate: averaged weights shift activation ranges)
            int8_work = os.path.join(work, f"eval_soup_{soup_tag}_int8")
            if not os.path.exists(os.path.join(build, "act_scales.json")):
                # freshly built dir: the cached int8 sweep would skip the
                # --calibrate side effect that writes act_scales.json —
                # force a fresh run
                cache = os.path.join(int8_work, "seg_scores.json")
                if os.path.exists(cache):
                    os.remove(cache)
            int8_scores = run_sweep(
                build, os.path.join(args.data_root, "eval"),
                int8_work, args.recipe, dtype="int8", calibrate=16)["seg"]
            if not int8_scores:
                raise RuntimeError("soup int8 confirm parsed no SEG scores "
                                   "— refusing to record 0.0")
            summary["eval_soup_int8_mean"] = round(
                sum(int8_scores.values()) / len(int8_scores), 4)
            summary["eval_soup_int8_per_seq"] = {
                k: round(v, 4) for k, v in int8_scores.items()}

        # everything succeeded — swap the artifact into place
        if os.path.isdir(args.best_dir):
            shutil.rmtree(args.best_dir)
        os.rename(build, args.best_dir)

    # --- prune stale step dirs ---------------------------------------------
    if args.prune:
        keep = set(best_two) | set(chosen) | {saved[-1]}
        pruned = []
        for s in saved:
            if s in keep:
                continue
            shutil.rmtree(os.path.join(ckpt_dir, str(s)), ignore_errors=True)
            pruned.append(s)
        summary["pruned_steps"] = pruned
        print(f"select_best: pruned {len(pruned)} step dirs, kept "
              f"{sorted(keep)}", flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
