"""Checkpoint-selection pipeline stage (scripts/select_best.py).

Round-3 lesson this stage encodes: single-sequence val/seg rank-inverted
against held-out SEG twice (VERDICT r3 weak 5), so selection ranks the last
saves on >=2 val sequences, soups the best two, and only CONFIRMS on eval.
These tests exercise ranking / soup / prune / durable-artifact logic with a
stubbed device sweep (no card, no subprocess).
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_module():
    spec = importlib.util.spec_from_file_location(
        "select_best", os.path.join(REPO, "scripts", "select_best.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_seg_line_parse_regex():
    sb = _load_module()
    out = ("[2026-08-18 12:00:00] SEG runs/heldout/train/Synth-N2DH-SIM/03: "
           "0.9135 (40 annotated frames)\n"
           "[2026-08-18 12:00:01] SEG runs/heldout/train/Synth-N2DH-SIM/10: "
           "0.8990 (100 annotated frames)\n")
    scores = {m.group(1): float(m.group(2)) for m in sb.SEG_RE.finditer(out)}
    assert scores == {"runs/heldout/train/Synth-N2DH-SIM/03:"[:-1]: 0.9135,
                      "runs/heldout/train/Synth-N2DH-SIM/10:"[:-1]: 0.8990}


def _fake_run(tmp_path, make_ckpt_steps=(6500, 7000, 7500, 8000)):
    """A fake training run dir with real (tiny) checkpoints."""
    from lstm_unet_tpu.checkpoint import CheckpointManager, save_model_params

    run = tmp_path / "v3bw_fake"
    ckpt = run / "ckpt"
    ckpt.mkdir(parents=True)
    save_model_params(str(ckpt), {"model_config": {}})
    mgr = CheckpointManager(str(ckpt))
    for i, s in enumerate(make_ckpt_steps):
        params = {"w": np.full((2, 2), float(i), np.float32)}
        mgr.save(s, params, {"count": np.int32(i)})
    mgr.wait()
    mgr.close()
    return run


def test_select_best_ranks_soups_prunes(tmp_path, monkeypatch):
    sb = _load_module()
    run = _fake_run(tmp_path)
    data = tmp_path / "heldout"
    (data / "train").mkdir(parents=True)
    (data / "eval").mkdir()
    recipe = tmp_path / "recipe.json"
    recipe.write_text(json.dumps({"cell_thresh": 0.55}))
    best_dir = tmp_path / "best"
    out_json = tmp_path / "select_best.json"

    # val means rank-invert vs step order on purpose: 7000 > 8000 > 7500
    # > 6500 — best two must be {7000, 8000}
    val_mean = {6500: 0.88, 7000: 0.93, 7500: 0.89, 8000: 0.91}
    calls = []

    def fake_sweep(model_path, data_root, output_root, recipe_arg,
                   seqs="", ckpt_step=0, dtype="", calibrate=0, timeout=0):
        calls.append((model_path, os.path.basename(data_root), ckpt_step,
                      dtype, calibrate))
        if ckpt_step:  # ranking pass on val
            m = val_mean[ckpt_step]
            return {"seg": {"val/03": m + 0.01, "val/10": m - 0.01},
                    "det": {"val/03": m, "val/10": m - 0.02}}
        if os.path.basename(data_root) == "train":
            # transient guard: the soup's own val sweep — here the soup
            # WINS (>= best single 0.93), so it ships
            return {"seg": {"val/03": 0.95, "val/10": 0.94}, "det": {}}
        return {"seg": {"eval/01": 0.92, "eval/02": 0.91, "eval/03": 0.93},
                "det": {"eval/01": 0.95}}

    monkeypatch.setattr(sb, "run_sweep", fake_sweep)
    monkeypatch.setattr(sys, "argv", [
        "select_best.py", "--model_path", str(run), "--data_root", str(data),
        "--val_seqs", "03,10", "--recipe", str(recipe),
        "--best_dir", str(best_dir), "--prune", "--skip_int8",
        "--out", str(out_json)])
    sb.main()

    s = json.loads(out_json.read_text())
    assert s["soup_steps"] == [7000, 8000]
    assert [r["step"] for r in s["val_ranking"]] == [7000, 8000, 7500, 6500]
    assert s["eval_soup_mean"] == 0.92
    # DET rides along: per-step val DET means + the SEG-vs-DET rank
    # agreement diagnostic (here DET ranks identically -> tau = 1)
    assert all("val_det_mean" in r for r in s["val_ranking"])
    assert s["val_seg_det_tau"] == 1.0
    assert s["eval_soup_det_mean"] == 0.95

    # durable artifact: standalone model dir loadable by the inference path
    assert os.path.exists(os.path.join(best_dir, "model_params.json"))
    assert os.path.exists(os.path.join(best_dir, "recipe.json"))
    prov = json.load(open(os.path.join(best_dir, "provenance.json")))
    assert prov["soup_steps"] == [7000, 8000]
    # the soup is the UNIFORM AVERAGE of steps 7000 (value 1.0) and 8000
    # (value 3.0) -> 2.0
    from lstm_unet_tpu.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(best_dir))
    restored = mgr.restore_params_only()
    mgr.close()
    assert np.allclose(restored["w"], 2.0)

    # prune keeps soup constituents + latest (here the same set) and drops
    # the rest
    left = sorted(int(d) for d in os.listdir(run / "ckpt") if d.isdigit())
    assert left == [7000, 8000]

    # eval was only ever swept with the SOUP (ckpt_step 0), never ranked
    eval_calls = [c for c in calls if c[1] == "eval"]
    assert all(c[2] == 0 for c in eval_calls) and len(eval_calls) == 1


def test_select_best_no_scores_fails_loud(tmp_path, monkeypatch):
    sb = _load_module()
    run = _fake_run(tmp_path, make_ckpt_steps=(500,))
    data = tmp_path / "heldout"
    (data / "train").mkdir(parents=True)
    monkeypatch.setattr(sb, "run_sweep",
                        lambda *a, **k: {"seg": {}, "det": {}})
    monkeypatch.setattr(sys, "argv", [
        "select_best.py", "--model_path", str(run), "--data_root", str(data)])
    with pytest.raises(RuntimeError, match="SEG scores"):
        sb.main()


def test_select_best_partial_val_set_fails_loud(tmp_path, monkeypatch):
    # a missing val sequence/GT must not silently shrink ranking to a
    # single sequence (the round-3 rank-inversion setup)
    import sys

    sb = _load_module()
    run = _fake_run(tmp_path, make_ckpt_steps=(500,))
    data = tmp_path / "heldout"
    (data / "train").mkdir(parents=True)
    monkeypatch.setattr(
        sb, "run_sweep",
        lambda *a, **k: {"seg": {"train/Synth-N2DH-SIM/03": 0.9}, "det": {}})
    monkeypatch.setattr(sys, "argv", [
        "select_best.py", "--model_path", str(run), "--data_root", str(data),
        "--val_seqs", "03,10"])
    with pytest.raises(RuntimeError, match="1 SEG scores for 2 requested"):
        sb.main()


if __name__ == "__main__":
    pytest.main([__file__, "-x", "-q"])


def test_kendall_tau_orderings():
    sb = _load_module()
    # identical ordering
    tau, c, d = sb.kendall_tau([(1, 10), (2, 20), (3, 30)])
    assert (tau, c, d) == (1.0, 3, 0)
    # fully inverted (the round-3 val-rank-inversion signature)
    tau, c, d = sb.kendall_tau([(1, 30), (2, 20), (3, 10)])
    assert (tau, c, d) == (-1.0, 0, 3)
    # tau-a: ties lower the score (2 concordant of 3 total pairs), unlike
    # the gamma this replaced which ignored them (ADVICE r4)
    tau, c, d = sb.kendall_tau([(1, 10), (1, 20), (2, 30)])
    assert c == 2 and d == 0 and tau == pytest.approx(2 / 3)


def test_run_sweep_score_cache(tmp_path):
    sb = _load_module()
    out_root = tmp_path / "val_8000"
    out_root.mkdir()
    seg = {"runs/heldout/train/Synth-N2DH-SIM/03": 0.91}
    fp = sb._sweep_fingerprint("/nonexistent/model", "", 0, "", 0)
    (out_root / "seg_scores.json").write_text(
        json.dumps({"fingerprint": fp, "seg": seg, "det": {}}))
    # the command would fail instantly if executed — the cache must win
    scores = sb.run_sweep("/nonexistent/model", "/nonexistent/data",
                          str(out_root), recipe="")
    assert scores == {"seg": seg, "det": {}}


def test_run_sweep_stale_cache_reruns(tmp_path):
    # ADVICE r4 medium: a cache produced under DIFFERENT inputs (legacy
    # fingerprint-less format, or another recipe/step/dtype) must NOT be
    # returned — the sweep re-runs (and here fails loud on the fake model
    # path, proving the cache was bypassed).
    sb = _load_module()

    # legacy flat format
    out_root = tmp_path / "val_legacy"
    out_root.mkdir()
    (out_root / "seg_scores.json").write_text(json.dumps({"val/03": 0.9}))
    with pytest.raises(Exception):  # rc!=0 or TimeoutExpired — either proves the re-run
        sb.run_sweep("/nonexistent/model", "/nonexistent/data",
                     str(out_root), recipe="", timeout=5)

    # fingerprint mismatch: same dir, different recipe content
    out_root2 = tmp_path / "val_recipe"
    out_root2.mkdir()
    recipe_a = tmp_path / "a.json"
    recipe_a.write_text(json.dumps({"cell_thresh": 0.55}))
    fp_a = sb._sweep_fingerprint("/nonexistent/model", str(recipe_a), 0, "", 0)
    (out_root2 / "seg_scores.json").write_text(
        json.dumps({"fingerprint": fp_a, "seg": {"val/03": 0.9}, "det": {}}))
    recipe_a.write_text(json.dumps({"cell_thresh": 0.60}))  # recalibrated
    with pytest.raises(Exception):  # rc!=0 or TimeoutExpired — either proves the re-run
        sb.run_sweep("/nonexistent/model", "/nonexistent/data",
                     str(out_root2), recipe=str(recipe_a), timeout=5)


def test_failed_rerun_preserves_previous_best_artifact(tmp_path, monkeypatch):
    # the durable artifact must survive a mid-stage failure: the soup is
    # built into best_dir.tmp and only swapped in after every confirm
    # succeeded
    sb = _load_module()
    run = _fake_run(tmp_path, make_ckpt_steps=(7000, 8000))
    data = tmp_path / "heldout"
    (data / "train").mkdir(parents=True)
    (data / "eval").mkdir()
    best_dir = tmp_path / "best"
    best_dir.mkdir()
    (best_dir / "PRECIOUS").write_text("previous round's artifact")

    def fake_sweep(model_path, data_root, output_root, recipe_arg,
                   seqs="", ckpt_step=0, dtype="", calibrate=0, timeout=0):
        if os.path.basename(data_root) == "train":  # ranking + soup val
            return {"seg": {"val/03": 0.9, "val/10": 0.9}, "det": {}}
        # eval confirm parses nothing -> must raise, not swap
        return {"seg": {}, "det": {}}

    monkeypatch.setattr(sb, "run_sweep", fake_sweep)
    monkeypatch.setattr(sys, "argv", [
        "select_best.py", "--model_path", str(run), "--data_root", str(data),
        "--val_seqs", "03,10", "--best_dir", str(best_dir), "--skip_int8"])
    with pytest.raises(RuntimeError, match="refusing to record 0.0"):
        sb.main()
    assert (best_dir / "PRECIOUS").read_text() == "previous round's artifact"


def test_transient_tail_ships_single_step_not_soup(tmp_path, monkeypatch):
    # r4 stage-9 lesson, now enforced in code: when the soup's own VAL score
    # is below the best single step's (mid-transient tail — e.g. v4ft saves
    # 10500 val 0.55 / 11000 val 0.86), the artifact must be the single
    # step, never the damaged average.
    sb = _load_module()
    run = _fake_run(tmp_path, make_ckpt_steps=(10500, 11000))
    data = tmp_path / "heldout"
    (data / "train").mkdir(parents=True)
    (data / "eval").mkdir()
    best_dir = tmp_path / "best"
    out_json = tmp_path / "s.json"

    val_mean = {10500: 0.55, 11000: 0.86}

    def fake_sweep(model_path, data_root, output_root, recipe_arg,
                   seqs="", ckpt_step=0, dtype="", calibrate=0, timeout=0):
        if ckpt_step:
            m = val_mean[ckpt_step]
            return {"seg": {"val/03": m}, "det": {}}
        if os.path.basename(data_root) == "train":
            return {"seg": {"val/03": 0.70}, "det": {}}  # soup LOSES on val
        return {"seg": {"eval/01": 0.84}, "det": {}}

    monkeypatch.setattr(sb, "run_sweep", fake_sweep)
    monkeypatch.setattr(sys, "argv", [
        "select_best.py", "--model_path", str(run), "--data_root", str(data),
        "--val_seqs", "03", "--best_dir", str(best_dir), "--skip_int8",
        "--out", str(out_json)])
    sb.main()

    s = json.loads(out_json.read_text())
    assert s["soup_steps"] == [10500, 11000]      # the candidate pair
    assert s["artifact_steps"] == [11000]          # ...but the single ships
    assert s["val_soup_mean"] == 0.7
    prov = json.load(open(os.path.join(best_dir, "provenance.json")))
    assert prov["soup_steps"] == [11000]
    # restored weights equal step 11000's params (value 1.0 in _fake_run),
    # not the (0.0 + 1.0)/2 average
    from lstm_unet_tpu.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(best_dir))
    restored = mgr.restore_params_only()
    mgr.close()
    assert np.allclose(restored["w"], 1.0)
