"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of
its phases works end to end at a tiny size (the card runs the flagship)."""

import os
import subprocess
import sys

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SZ = chip_smoke.TINY


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "not a GPU" in r.stderr


def test_phase1_compiles_every_stream_and_train_variant(capsys):
    chip_smoke.phase1_compile(SZ)
    out = capsys.readouterr().out
    assert out.count("compiled in") == 6


def test_phase2_main_path_without_optional_packages(tmp_path, monkeypatch,
                                                    capsys):
    """train2d -> checkpoint -> inference2d (bf16 and calibrated int8) with
    orbax, cv2 and PIL unimportable."""
    for mod in ("orbax", "orbax.checkpoint", "cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)
    import lstm_unet_tpu.io.tiff as tiff

    monkeypatch.setattr(tiff, "_cv2", None)
    monkeypatch.setattr(tiff, "_pil", None)
    out = chip_smoke.phase2_main_path(SZ, str(tmp_path), "cpu")
    assert out["train_steps_per_s"] > 0
    assert "uint16 masks" in capsys.readouterr().out


def test_phase3_reference_helpers():
    """The streaming-logits reference and the train-step metrics the card
    compares, here on the CPU against themselves."""
    cpu = chip_smoke.cpu_reference_logits(SZ)
    assert cpu.shape == (1, SZ.stream_hw, SZ.stream_hw, 3)
    assert np.isfinite(cpu).all() and np.abs(cpu).max() > 0
    assert chip_smoke.rel_err(cpu, cpu) == 0.0
    m = chip_smoke.train_step_metrics(SZ, "float32")
    assert np.isfinite(m["loss"]) and m["grad_norm"] > 0


def test_postprocess_gt_probs_match_cpu_and_gt_count():
    got, cpu, n_gt = chip_smoke.postprocess_vs_cpu(128, cells=8, seed=5)
    np.testing.assert_array_equal(got, cpu)
    assert len(np.unique(got[got > 0])) == n_gt > 0


def test_relabel_pair_bit_identical():
    (mm, n_mm), (sc, n_sc) = chip_smoke.relabel_pair(128, cells=8)
    np.testing.assert_array_equal(np.asarray(mm), np.asarray(sc))
    assert int(n_mm) == int(n_sc) > 0


def test_phase4_times_every_plain_twin():
    out = chip_smoke.phase4_kernels(SZ, "cpu")
    assert set(out) == {"stream_bfloat16_fps", "stream_int8_fps",
                        "level0_step_fwd_ms", "gate_update_ms",
                        "level0_step_fwd_bwd_ms", "ccl_ms",
                        "relabel_matmul_ms", "relabel_scatter_ms"}
    assert all(v > 0 for v in out.values())


def test_four_card_training_matches_one_card_on_virtual_devices(tmp_path):
    assert len(jax.devices()) >= 4  # conftest: 8 virtual CPU devices
    chip_smoke.four_card_training(SZ, str(tmp_path))
