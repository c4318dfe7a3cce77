"""CLI argument-surface tests (reference contract: argparse overrides map
onto Params fields — SURVEY.md §1 L3)."""

import json
import os

import pytest

from lstm_unet_tpu.cli.inference2d import build_parser as infer_parser
from lstm_unet_tpu.cli.train2d import _parse_seq_list, build_parser as train_parser


def test_train_parser_seq_list_and_types():
    args = train_parser().parse_args([
        "--train_sequence_list", "Fluo-N2DH-SIM+:01,DIC-C2DH-HeLa:02",
        "--crop_size", "128", "96",
        "--batch_size", "3",
        "--class_weights", "0.1", "0.3", "0.6",
        "--dry_run",
        "--gt_is_full_seg", "false",
    ])
    assert args.train_sequence_list == [("Fluo-N2DH-SIM+", "01"),
                                        ("DIC-C2DH-HeLa", "02")]
    assert args.crop_size == [128, 96]
    assert args.batch_size == 3
    assert args.dry_run is True
    assert args.gt_is_full_seg is False


def test_train_parser_rss_and_compact_upload_flags():
    # omitted → None, so params.override keeps the CTCParams defaults
    a = train_parser().parse_args([])
    assert a.rss_relaunch_gb is None and a.compact_upload is None
    a = train_parser().parse_args(
        ["--rss_relaunch_gb", "64", "--no-compact_upload"])
    assert a.rss_relaunch_gb == 64.0 and a.compact_upload is False


def test_seq_list_handles_colons_in_dataset_name():
    # rsplit: only the LAST colon separates the sequence id
    assert _parse_seq_list("weird:name:01") == [("weird:name", "01")]


def test_infer_parser_requires_paths():
    with pytest.raises(SystemExit):
        infer_parser().parse_args(["--model_path", "x"])  # missing required
    args = infer_parser().parse_args([
        "--model_path", "m", "--sequence_path", "s", "--output_path", "o",
        "--FOV", "25", "--digit_4",
        "--boundary_growth", "dilate", "--grow_iters", "5",
    ])
    assert args.FOV == 25 and args.digit_4 is True
    assert args.boundary_growth == "dilate" and args.grow_iters == 5
    with pytest.raises(SystemExit):  # invalid growth mode rejected
        infer_parser().parse_args([
            "--model_path", "m", "--sequence_path", "s", "--output_path", "o",
            "--boundary_growth", "bogus"])


def test_unset_flags_do_not_override_defaults():
    """None-valued argparse results must not clobber CTCInferenceParams
    defaults (override() skips None)."""
    from lstm_unet_tpu.config import CTCInferenceParams

    args = vars(infer_parser().parse_args(
        ["--model_path", "m", "--sequence_path", "s", "--output_path", "o"]))
    p = CTCInferenceParams()
    default_min = p.min_cell_size
    p.override(**args)
    assert p.min_cell_size == default_min
    assert p.model_path == "m"


def test_infer_parser_int8_calibrate_fused_surface():
    args = infer_parser().parse_args([
        "--model_path", "m", "--sequence_path", "s", "--output_path", "o",
        "--dtype", "int8", "--calibrate", "8",
        "--state_dtype", "float32",
    ])
    assert args.dtype == "int8" and args.calibrate == 8
    assert args.state_dtype == "float32"


def test_import_tf_parser_surface(tmp_path):
    """--list on a fabricated bundle prints variables and exits cleanly."""
    import numpy as np

    from lstm_unet_tpu.checkpoint.tf_bundle import write_bundle
    from lstm_unet_tpu.cli.import_tf import main as import_main

    prefix = str(tmp_path / "model.ckpt")
    write_bundle(prefix, {"a/kernel": np.zeros((2, 2), np.float32)})
    import_main(["--tf_prefix", prefix, "--output_dir", str(tmp_path / "o"),
                 "--list"])


def test_train2d_cli_continue_run_reuses_dir(tmp_path):
    """The CLI must NOT pre-resolve a fresh timestamped dir when
    --continue_run has no explicit load path — the Trainer reuses the
    latest matching experiment dir (the library path alone once had this
    fix, not the CLI)."""
    import json
    import os

    from lstm_unet_tpu.cli.train2d import main as train_main
    from lstm_unet_tpu.config import tiny_net_kernel_params
    from lstm_unet_tpu.io.synthetic import write_ctc_dataset

    root = str(tmp_path / "data")
    write_ctc_dataset(root, num_frames=8, height=32, width=32, num_cells=3,
                      seed=2)
    nkp = json.dumps(tiny_net_kernel_params().to_dict())
    common = [
        "--root_data_dir", root,
        "--train_sequence_list", "Synth-N2DH-SIM:01",
        "--root_save_dir", str(tmp_path / "runs"),
        "--experiment_name", "cli_resume",
        "--net_kernel_params", nkp,
        "--crop_size", "32", "32", "--batch_size", "2", "--unroll_len", "2",
        "--validation_interval", "1000000",
        "--print_to_console_interval", "1000000",
        "--write_to_tb_interval", "1000000",
        "--save_checkpoint_iteration", "4",
    ]
    train_main(common + ["--num_iterations", "4"])
    runs = os.listdir(str(tmp_path / "runs"))
    assert len(runs) == 1
    train_main(common + ["--num_iterations", "6", "--continue_run"])
    runs_after = os.listdir(str(tmp_path / "runs"))
    assert runs_after == runs, "continue_run must reuse the existing dir"
    ckpt = os.path.join(str(tmp_path / "runs"), runs[0], "ckpt")
    steps = sorted(d for d in os.listdir(ckpt) if d.isdigit())
    assert "4" in steps and any(int(s) > 4 for s in steps), steps


# --------------------------------------------------------------------------
# --recipe flag (round 4): one-flag reproduction of the measured-best knobs
# --------------------------------------------------------------------------


def test_load_recipe_recommended_and_winner_formats(tmp_path):
    from lstm_unet_tpu.config import CTCInferenceParams, load_recipe

    # repo-shipped recommended recipe: applies cleanly to inference params
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = CTCInferenceParams()
    knobs = load_recipe(os.path.join(repo, "configs", "recommended.json"),
                        known=set(vars(p)))
    assert "_comment" not in knobs and "class_weights" not in knobs
    p.override(**knobs)
    assert p.cell_thresh == 0.55 and p.size_filter == "post"
    assert p.instance_split is True and p.split_method == "prob"

    # calibrate_recipe.py output format: the "winner" dict is unwrapped,
    # "fov" aliases FOV, instance_split implies the prob splitter
    calib = {"val_best": 0.9, "winner": {
        "cell_thresh": 0.6, "edge_thresh": 0.25, "min_cell_size": 50,
        "grow_iters": 0, "size_filter": "pre", "fov": 3,
        "instance_split": True, "split_hi_thresh": 0.75,
        "split_erode": 2, "split_min_size": 2500}}
    f = tmp_path / "recipe_calibration.json"
    f.write_text(json.dumps(calib))
    r = load_recipe(str(f))
    assert r["FOV"] == 3 and "fov" not in r
    assert r["split_method"] == "prob"
    assert r["cell_thresh"] == 0.6


def test_load_recipe_train_keys_filtered_for_inference(tmp_path):
    from lstm_unet_tpu.config import CTCInferenceParams, load_recipe

    f = tmp_path / "r.json"
    f.write_text(json.dumps({"class_weights": [0.1, 0.25, 0.65],
                             "cell_thresh": 0.55}))
    p = CTCInferenceParams()
    knobs = load_recipe(str(f), known=set(vars(p)))
    assert knobs == {"cell_thresh": 0.55}  # training key dropped
    # unfiltered: lists become tuples (CTCParams.class_weights contract)
    assert load_recipe(str(f))["class_weights"] == (0.1, 0.25, 0.65)


def test_parsers_accept_recipe_and_watchdog_flags():
    args = infer_parser().parse_args([
        "--model_path", "m", "--sequence_path", "s", "--output_path", "o",
        "--recipe", "configs/recommended.json", "--watchdog_secs", "600"])
    assert args.recipe == "configs/recommended.json"
    assert args.watchdog_secs == 600.0
    targs = train_parser().parse_args(["--recipe", "x.json"])
    assert targs.recipe == "x.json"


def test_resolve_model_dir_accepts_run_dir(tmp_path):
    # the chip pipeline passes the RUN dir; model_params.json lives under
    # <run>/ckpt (Trainer layout) — both must resolve to the same place
    from lstm_unet_tpu.checkpoint import resolve_model_dir

    run = tmp_path / "v3bw_x"
    ckpt = run / "ckpt"
    ckpt.mkdir(parents=True)
    (ckpt / "model_params.json").write_text("{}")
    assert resolve_model_dir(str(run)) == str(ckpt)
    assert resolve_model_dir(str(ckpt)) == str(ckpt)
    # unknown dirs come back unchanged (error messages stay honest)
    assert resolve_model_dir(str(tmp_path / "nope")) == str(tmp_path / "nope")


def test_apply_recipe_explicit_flags_win(tmp_path):
    # regression: --recipe used to clobber explicitly passed CLI flags
    import argparse
    import json

    from lstm_unet_tpu.cli.ctc_sweep import apply_recipe

    ap = argparse.ArgumentParser()
    ap.add_argument("--recipe", default="")
    ap.add_argument("--cell_thresh", type=float, default=0.5)
    ap.add_argument("--size_filter", default="pre")
    ap.add_argument("--model_path", default="orig")
    f = tmp_path / "recipe.json"
    f.write_text(json.dumps({"cell_thresh": 0.55, "size_filter": "post",
                             "model_path": "evil"}))
    argv = ["--recipe", str(f), "--cell_thresh", "0.6"]
    args = ap.parse_args(argv)
    applied = apply_recipe(ap, args, argv)
    assert args.cell_thresh == 0.6          # explicit flag wins
    assert args.size_filter == "post"       # recipe fills the default
    assert args.model_path == "orig"        # infra keys never applied
    assert applied == {"size_filter": "post"}


def test_apply_recipe_eq_form_counts_as_explicit(tmp_path):
    import argparse
    import json

    from lstm_unet_tpu.cli.ctc_sweep import apply_recipe

    ap = argparse.ArgumentParser()
    ap.add_argument("--recipe", default="")
    ap.add_argument("--cell_thresh", type=float, default=0.5)
    f = tmp_path / "recipe.json"
    f.write_text(json.dumps({"cell_thresh": 0.55}))
    argv = ["--recipe", str(f), "--cell_thresh=0.6"]
    args = ap.parse_args(argv)
    apply_recipe(ap, args, argv)
    assert args.cell_thresh == 0.6


def test_apply_recipe_prefix_abbrev_counts_as_explicit(tmp_path):
    # ADVICE r4: argparse accepts unambiguous prefix abbreviations
    # (--cell_th for --cell_thresh); an abbreviated-but-explicit flag must
    # still beat the recipe key
    import argparse
    import json

    from lstm_unet_tpu.cli.ctc_sweep import apply_recipe

    ap = argparse.ArgumentParser()
    ap.add_argument("--recipe", default="")
    ap.add_argument("--cell_thresh", type=float, default=0.5)
    ap.add_argument("--size_filter", default="pre")
    f = tmp_path / "recipe.json"
    f.write_text(json.dumps({"cell_thresh": 0.55, "size_filter": "post"}))
    argv = ["--recipe", str(f), "--cell_th=0.6"]
    args = ap.parse_args(argv)
    apply_recipe(ap, args, argv)
    assert args.cell_thresh == 0.6          # abbreviated explicit flag wins
    assert args.size_filter == "post"       # untouched key still filled
