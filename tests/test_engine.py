"""Engine tests (SURVEY.md §4): train on synthetic data (loss decreases),
checkpoint round-trip into inference, CTC-format output, SEG metric."""

import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lstm_unet_tpu.config import (
    CTCInferenceParams,
    CTCParams,
    tiny_net_kernel_params,
)
from lstm_unet_tpu.engine.infer import run_inference
from lstm_unet_tpu.engine.loss import weighted_ce_loss
from lstm_unet_tpu.engine.train import Trainer
from lstm_unet_tpu.io.synthetic import write_ctc_dataset
from lstm_unet_tpu.io.tiff import read_tiff
from lstm_unet_tpu.metrics import seg_measure, seg_measure_sequence


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ctc"))
    write_ctc_dataset(root, num_frames=12, height=32, width=32, num_cells=3,
                      seed=1)
    return root


def _params(root, tmp, **kw):
    defaults = dict(
        root_data_dir=root,
        train_sequence_list=[("Synth-N2DH-SIM", "01")],
        val_sequence_list=[("Synth-N2DH-SIM", "01")],
        crop_size=(32, 32),
        batch_size=2,
        unroll_len=3,
        net_kernel_params=tiny_net_kernel_params(),
        learning_rate=3e-3,
        root_save_dir=str(tmp),
        print_to_console_interval=20,
        validation_interval=25,
        save_checkpoint_iteration=10000,
        write_to_tb_interval=10000,
        num_prefetch_threads=1,
    )
    defaults.update(kw)
    return CTCParams(**defaults)


def test_weighted_ce_loss_masking():
    logits = jnp.zeros((1, 2, 4, 4, 3))
    labels = jnp.ones((1, 2, 4, 4), jnp.int32)
    valid_all = jnp.ones((1, 2))
    valid_none = jnp.zeros((1, 2))
    l1, acc = weighted_ce_loss(logits, labels, valid_all, (1.0, 1.0, 1.0))
    l0, _ = weighted_ce_loss(logits, labels, valid_none, (1.0, 1.0, 1.0))
    assert float(l1) == pytest.approx(np.log(3), rel=1e-5)
    assert float(l0) == 0.0


def test_train_loss_decreases_and_ckpt_roundtrip(synth_root, tmp_path):
    p = _params(synth_root, tmp_path)
    trainer = Trainer(p, seed=0)

    # measure loss before and after a short training run on the same data
    first = trainer.train(num_iterations=2)
    late = trainer.train(num_iterations=60)
    assert late["loss"] < first["loss"], (first, late)

    # checkpoint was written with arch json
    save_dir = p.experiment_save_dir
    assert os.path.exists(os.path.join(save_dir, "model_params.json"))

    # --- inference from the checkpoint produces CTC-format masks ---
    seq_dir = os.path.join(synth_root, "Synth-N2DH-SIM", "01")
    out_dir = str(tmp_path / "res")
    ip = CTCInferenceParams(
        model_path=save_dir,
        sequence_path=seq_dir,
        output_path=out_dir,
        pre_sequence_frames=2,
        min_cell_size=5,
        dtype="float32",
        save_intermediate=True,
    )
    n = run_inference(ip)
    masks = sorted(glob.glob(os.path.join(out_dir, "mask*.tif")))
    assert n == 12 and len(masks) == 12
    m0 = read_tiff(masks[0])
    assert m0.dtype == np.uint16 and m0.shape == (32, 32)
    probs = sorted(glob.glob(os.path.join(out_dir, "intermediate", "probs*.npy")))
    assert len(probs) == 12
    assert np.load(probs[0]).shape == (32, 32, 3)


def test_trainer_continue_run(synth_root, tmp_path):
    p = _params(synth_root, tmp_path, save_checkpoint_iteration=5)
    t1 = Trainer(p, seed=0)
    t1.train(num_iterations=6)
    step1 = t1.global_step

    p2 = _params(synth_root, tmp_path, continue_run=True)
    p2.experiment_log_dir = p.experiment_log_dir
    p2.experiment_save_dir = p.experiment_save_dir
    t2 = Trainer(p2, seed=1)
    assert t2.global_step == step1


# ------------------------------------------------------------------ SEG


def test_seg_measure_hand_computed():
    gt = np.zeros((8, 8), np.int32)
    pred = np.zeros((8, 8), np.int32)
    gt[0:4, 0:4] = 1       # 16 px
    pred[0:4, 0:2] = 7     # overlap 8 px — exactly half, NOT strict majority
    s, n = seg_measure(gt, pred)
    assert n == 1 and s == 0.0

    pred[0:4, 0:3] = 7     # overlap 12 px > 8 → J = 12/(16+12-12) = 0.75
    s, n = seg_measure(gt, pred)
    assert n == 1 and s == pytest.approx(0.75)

    # second GT object with perfect match
    gt[6:8, 6:8] = 2
    pred[6:8, 6:8] = 3
    s, n = seg_measure(gt, pred)
    assert n == 2 and s == pytest.approx(0.75 + 1.0)


def test_seg_measure_sequence_mean():
    gt = np.zeros((4, 4), np.int32)
    gt[0:2, 0:2] = 1
    score = seg_measure_sequence([gt, gt], [gt, np.zeros_like(gt)])
    assert score == pytest.approx(0.5)


def test_full_seg_partial_frames_train_on_labeled_pixels_only():
    """Partial-annotation masking (reference full_seg indicator [M])."""
    import jax.numpy as jnp

    logits = jnp.zeros((1, 1, 2, 2, 3)).at[0, 0, 0, 0, 1].set(10.0)
    labels = jnp.zeros((1, 1, 2, 2), jnp.int32).at[0, 0, 0, 0].set(1)
    valid = jnp.ones((1, 1))
    # fully annotated: all 4 pixels count
    l_full, _ = weighted_ce_loss(logits, labels, valid, (1, 1, 1),
                                 jnp.ones((1, 1)))
    # partial: only the labeled pixel counts -> loss ~0 (it's predicted right)
    l_part, _ = weighted_ce_loss(logits, labels, valid, (1, 1, 1),
                                 jnp.zeros((1, 1)))
    assert float(l_part) < 1e-3 < float(l_full)


def test_reader_emits_full_seg_and_elastic(synth_root, tmp_path):
    from lstm_unet_tpu.io.dataset import CTCRAMReaderSequence2D

    # force the partial-annotation path (the synthetic "SIM" dataset would
    # otherwise auto-flag as fully annotated)
    p = _params(synth_root, tmp_path, elastic_augmentation=True, dry_run=True,
                gt_is_full_seg=False)
    reader = CTCRAMReaderSequence2D(p, num_threads=1)
    reader.start_queues()
    img, seg, valid, full_seg, is_last = reader.get_batch()
    reader.stop()
    assert full_seg.shape == valid.shape
    assert np.all(full_seg == 0) and np.any(valid > 0)
    assert sorted(np.unique(seg).tolist()) <= [0, 1, 2]

    # default heuristic: "SIM" in the dataset name -> fully annotated
    p2 = _params(synth_root, tmp_path, dry_run=True)
    reader2 = CTCRAMReaderSequence2D(p2, num_threads=1)
    reader2.start_queues()
    _, _, valid2, full2, _ = reader2.get_batch()
    reader2.stop()
    np.testing.assert_array_equal(full2, valid2)


def test_inference_digit4_naming(synth_root, tmp_path):
    p = _params(synth_root, tmp_path)
    t = Trainer(p, seed=0)
    t.train(num_iterations=2)
    ip = CTCInferenceParams(
        model_path=p.experiment_save_dir,
        sequence_path=os.path.join(synth_root, "Synth-N2DH-SIM", "01"),
        output_path=str(tmp_path / "d4"), dtype="float32", digit_4=True)
    run_inference(ip)
    assert os.path.exists(str(tmp_path / "d4" / "mask0000.tif"))


def test_prefetcher_propagates_reader_errors():
    from lstm_unet_tpu.engine.infer import _Prefetcher

    def bad_iter():
        yield 1
        raise RuntimeError("corrupt frame")

    pf = _Prefetcher(bad_iter())
    it = iter(pf)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="corrupt frame"):
        next(it)


def test_val_seg_hand_computed():
    """Trainer._val_seg == hand-computed per-object Jaccard (VERDICT r1 #5)."""
    import types

    from lstm_unet_tpu.engine.train import Trainer

    h = w = 16
    inst = np.zeros((1, 2, h, w), np.int32)
    inst[0, 0, 2:8, 2:8] = 4          # one GT object, 36 px
    probs = np.zeros((1, 2, h, w, 3), np.float32)
    probs[..., 0] = 1.0
    probs[0, 0, 2:8, 2:6, 1] = 1.0    # predicted interior 24 px ⊂ GT
    probs[0, 0, ..., 0] = 1.0 - probs[0, 0, ..., 1]
    valid = np.array([[1.0, 0.0]], np.float32)  # frame 1 unannotated
    fake = types.SimpleNamespace(p=types.SimpleNamespace(val_seg_min_cell_size=5))
    score = Trainer._val_seg(fake, jnp.asarray(probs), inst, valid)
    # J = 24 / (36 + 24 - 24) = 2/3
    assert score == pytest.approx(24 / 36)
    # DET: the 24px prediction covers >half of the 36px GT object → matched,
    # no FN/FP/splits → perfect detection despite the imperfect Jaccard
    seg, det = Trainer._val_objscores(fake, jnp.asarray(probs), inst, valid)
    assert seg == pytest.approx(24 / 36)
    assert det == pytest.approx(1.0)


def test_validation_reports_per_object_seg(synth_root, tmp_path):
    """The validation loop scores real per-object SEG (postprocess on val
    predictions vs augmented instance GT) and exposes/logs it."""
    p = _params(synth_root, tmp_path, validation_interval=10, dry_run=True,
                val_seg_min_cell_size=3)
    t = Trainer(p, seed=0)
    t.train(num_iterations=12)
    assert "seg" in t.last_val_metrics
    assert 0.0 <= t.last_val_metrics["seg"] <= 1.0
    assert "det" in t.last_val_metrics
    assert 0.0 <= t.last_val_metrics["det"] <= 1.0


def test_reader_instance_augmentation_lockstep(synth_root, tmp_path):
    """return_instances: the instance map must stay aligned with the 3-class
    map under crop/flip/rot augmentation (interior pixels keep instance id)."""
    from lstm_unet_tpu.io.dataset import CTCRAMReaderSequence2D

    p = _params(synth_root, tmp_path, dry_run=True)
    reader = CTCRAMReaderSequence2D(p, num_threads=1, return_instances=True)
    reader.start_queues()
    img, seg, valid, full, is_last, inst = reader.get_batch()
    reader.stop()
    assert inst.shape == seg.shape and inst.dtype == np.int32
    # every interior pixel (class 1) must carry a nonzero instance id
    assert np.all(inst[seg == 1] > 0)
    assert np.all(inst[seg == 0] == 0)


def test_async_writer_fails_fast(tmp_path):
    """A write error must surface on the NEXT put(), not at close()."""
    import time

    from lstm_unet_tpu.engine.infer import _AsyncWriter

    w = _AsyncWriter()
    # float32 is rejected by write_tiff — a deterministic write error
    w.put(str(tmp_path / "x.tif"), np.zeros((4, 4), np.float32))
    err = None
    for _ in range(100):  # writer thread needs a moment to hit the error
        try:
            w.put(str(tmp_path / "ok.tif"), np.zeros((4, 4), np.uint16))
        except Exception as e:
            err = e
            break
        time.sleep(0.05)
    assert err is not None, "writer never surfaced the error on put()"
    w.close()  # an already-surfaced error must not re-raise here


def test_reader_producer_errors_propagate(synth_root, tmp_path):
    """A dead producer thread must raise in get_batch, not hang it (ADVICE r1)."""
    from lstm_unet_tpu.io.dataset import CTCRAMReaderSequence2D

    p = _params(synth_root, tmp_path, dry_run=True)
    reader = CTCRAMReaderSequence2D(p, num_threads=1)
    def boom(*a, **k):
        raise RuntimeError("producer boom")
    reader._window = boom
    reader.start_queues()
    with pytest.raises(RuntimeError, match="producer boom"):
        reader.get_batch()
    reader.stop()


def test_reader_stop_drains_queue(synth_root, tmp_path):
    """stop() must drop stale mid-sequence windows so a restarted train()
    pairs fresh LSTM state with fresh traversals (ADVICE r1)."""
    import time

    from lstm_unet_tpu.io.dataset import CTCRAMReaderSequence2D

    p = _params(synth_root, tmp_path, dry_run=True)
    reader = CTCRAMReaderSequence2D(p, num_threads=1)
    reader.start_queues()
    reader.get_batch()
    time.sleep(0.3)  # let the producer refill the queues
    reader.stop()
    assert all(q.empty() for q in reader._lane_qs)
    reader.start_queues()  # restart serves fresh windows
    reader.get_batch()
    reader.stop()


def test_reader_thread_count_invariant_stream(synth_root, tmp_path):
    """The produced stream is bit-identical for any producer thread count:
    lane streams are pure functions of (seed, lane), threads only change who
    computes a window (the multi-producer BPTT-safety design)."""
    from lstm_unet_tpu.io.dataset import CTCRAMReaderSequence2D

    p = _params(synth_root, tmp_path, dry_run=True)
    p.batch_size = 3
    batches = {}
    for n in (1, 3):
        reader = CTCRAMReaderSequence2D(p, num_threads=n, seed=11)
        assert reader.num_threads == n
        reader.start_queues()
        batches[n] = [reader.get_batch() for _ in range(8)]
        reader.stop()
    for b1, b3 in zip(batches[1], batches[3]):
        for a, b in zip(b1, b3):
            np.testing.assert_array_equal(a, b)


def test_trainer_with_multithreaded_reader(synth_root, tmp_path):
    """Training consumes a num_prefetch_threads=2 reader: loss finite,
    per-lane resets still line up (continuity is per lane queue)."""
    p = _params(synth_root, tmp_path, dry_run=True)
    p.num_prefetch_threads = 2
    p.batch_size = 2
    t = Trainer(p, seed=0)
    m = t.train(num_iterations=6)
    assert np.isfinite(m["loss"])


def test_seeded_finetune_resume_prefers_own_progress(synth_root, tmp_path):
    """A retry-supervisor relaunch of a SEEDED fine-tune (continue_run +
    load_checkpoint_path both set) must resume the run's own latest
    checkpoint, not restart from the older seed; the seed wins only while
    the run has no checkpoint of its own (round-3 fix: train_retry.sh keeps
    --load_checkpoint_path in ARGS on relaunch)."""
    seed_p = _params(synth_root, tmp_path, save_checkpoint_iteration=5)
    t_seed = Trainer(seed_p, seed=0)
    t_seed.train(num_iterations=5)

    # first fine-tune launch: fresh dir, restores the seed step
    ft = _params(synth_root, tmp_path, experiment_name="ft",
                 save_checkpoint_iteration=3, load_checkpoint=True,
                 load_checkpoint_path=seed_p.experiment_save_dir)
    t1 = Trainer(ft, seed=1)
    assert t1.global_step == 5
    t1.train(num_iterations=8)  # periodic + final saves of its own

    # relaunch as the supervisor would: same args + continue_run
    ft2 = _params(synth_root, tmp_path, experiment_name="ft",
                  continue_run=True, load_checkpoint=True,
                  load_checkpoint_path=seed_p.experiment_save_dir)
    t2 = Trainer(ft2, seed=2)
    assert t2.global_step == t1.global_step, \
        "in-run checkpoint must outrank the seed"
    assert ft2.experiment_save_dir == ft.experiment_save_dir

    # relaunch BEFORE any fine-tune save: the seed still wins (the
    # watchdog-during-first-compile case — warn-and-fresh would lose the
    # seed weights entirely)
    ft3 = _params(synth_root, tmp_path, experiment_name="ft_nosave",
                  continue_run=True, load_checkpoint=True,
                  load_checkpoint_path=seed_p.experiment_save_dir)
    t3 = Trainer(ft3, seed=3)
    assert t3.global_step == 5


def test_seeded_finetune_target_survives_relaunch(synth_root, tmp_path):
    """The run-level TOTAL-step target of a SEEDED fine-tune is
    seed_step + num_iterations, recorded at first launch — a supervisor
    relaunch resumes toward THAT target instead of comparing the restored
    step against num_iterations (caught live r4: a fine-tune seeded at
    step 8000 with num_iterations=3000 was watchdog-relaunched and resumed
    as '0 steps remain', silently skipping its last 2000 steps)."""
    seed_p = _params(synth_root, tmp_path, save_checkpoint_iteration=5)
    t_seed = Trainer(seed_p, seed=0)
    t_seed.train(num_iterations=5)

    # first fine-tune launch: budget = 8 steps ON TOP of the seed's 5
    ft = _params(synth_root, tmp_path, experiment_name="fttgt",
                 num_iterations=8, save_checkpoint_iteration=3,
                 load_checkpoint=True,
                 load_checkpoint_path=seed_p.experiment_save_dir)
    t1 = Trainer(ft, seed=1)
    assert t1.target_step == 13
    t1.train(num_iterations=4)  # interrupted mid-fine-tune (final save: 9)

    # supervisor relaunch: same args + continue_run; default budget must
    # be target(13) - restored(9), not max(0, 8 - 9) == 0
    ft2 = _params(synth_root, tmp_path, experiment_name="fttgt",
                  num_iterations=8, save_checkpoint_iteration=3,
                  continue_run=True, load_checkpoint=True,
                  load_checkpoint_path=seed_p.experiment_save_dir)
    t2 = Trainer(ft2, seed=2)
    assert t2.target_step == 13
    assert t2.global_step == 9  # t1's final save
    t2.train()  # no explicit budget — the continue_run branch decides
    assert t2.global_step == 13

    # a further relaunch at the target trains 0 more steps (idempotent)
    ft3 = _params(synth_root, tmp_path, experiment_name="fttgt",
                  num_iterations=8, save_checkpoint_iteration=3,
                  continue_run=True, load_checkpoint=True,
                  load_checkpoint_path=seed_p.experiment_save_dir)
    t3 = Trainer(ft3, seed=3)
    t3.train()
    assert t3.global_step == 13

    # RAISING num_iterations on relaunch still extends the run: effective
    # target = max(recorded, initial_step + num_iterations) = max(13, 5+10)
    ft4 = _params(synth_root, tmp_path, experiment_name="fttgt",
                  num_iterations=10, save_checkpoint_iteration=3,
                  continue_run=True, load_checkpoint=True,
                  load_checkpoint_path=seed_p.experiment_save_dir)
    t4 = Trainer(ft4, seed=4)
    t4.train()
    assert t4.global_step == 15
    assert t4.target_step == 15  # extension persisted for later relaunches


def test_continue_run_finds_latest_run_dir(synth_root, tmp_path):
    """continue_run without load_checkpoint_path must reuse the newest
    experiment dir instead of creating an empty timestamped one (ADVICE r1)."""
    p = _params(synth_root, tmp_path, save_checkpoint_iteration=5)
    t1 = Trainer(p, seed=0)
    t1.train(num_iterations=6)
    step1 = t1.global_step

    p2 = _params(synth_root, tmp_path, continue_run=True)  # no dirs given
    t2 = Trainer(p2, seed=1)
    assert t2.global_step == step1
    assert p2.experiment_save_dir == p.experiment_save_dir


def test_async_periodic_saves_restorable(synth_root, tmp_path):
    """Periodic saves snapshot to non-donated buffers and drain async; the
    step loop keeps running and every periodic step is restorable
    (VERDICT r1 #6)."""
    p = _params(synth_root, tmp_path, save_checkpoint_iteration=4)
    t = Trainer(p, seed=0)
    t.train(num_iterations=9)  # periodic at steps 4, 8; barriered final at 9
    from lstm_unet_tpu.checkpoint import CheckpointManager

    mgr = CheckpointManager(p.experiment_save_dir)
    steps = set(mgr.all_steps())
    assert {4, 8, 9} <= steps
    # the async-saved step restores cleanly
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), t.model_params)
    params4 = mgr.restore_params_only(abstract, step=4)
    assert jax.tree_util.tree_structure(params4) == \
        jax.tree_util.tree_structure(t.model_params)

    # ckpt_step plumbing: load_model(step=) restores that step's weights,
    # not the latest (model selection on val/seg without touching the dir)
    from lstm_unet_tpu.engine.infer import load_model

    sel4, _ = load_model(p.experiment_save_dir, step=4)
    latest, _ = load_model(p.experiment_save_dir)
    head4 = jax.tree_util.tree_leaves(sel4)[0]
    headL = jax.tree_util.tree_leaves(latest)[0]
    assert head4.shape == headL.shape
    assert not np.allclose(np.asarray(head4), np.asarray(headL))
    assert np.array_equal(np.asarray(head4),
                          np.asarray(jax.tree_util.tree_leaves(params4)[0]))


def test_average_checkpoints_soup(synth_root, tmp_path):
    """Checkpoint averaging: the soup dir is a standard params-only model
    dir whose leaves are the element-wise mean of the averaged steps, and
    the source training dir keeps all of its checkpoints."""
    p = _params(synth_root, tmp_path, save_checkpoint_iteration=4)
    t = Trainer(p, seed=0)
    t.train(num_iterations=9)
    from lstm_unet_tpu.checkpoint import CheckpointManager, average_checkpoints
    from lstm_unet_tpu.engine.infer import load_model

    out = str(tmp_path / "soup")
    out_step = average_checkpoints(p.experiment_save_dir, out, steps=[4, 8])
    assert out_step == 8

    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), t.model_params)
    src = CheckpointManager(p.experiment_save_dir)
    p4 = src.restore_params_only(abstract, step=4)
    p8 = src.restore_params_only(abstract, step=8)
    assert {4, 8, 9} <= set(src.all_steps())  # source dir untouched

    soup, _cfg = load_model(out)  # standard load path, no special casing
    l4 = jax.tree_util.tree_leaves(p4)
    l8 = jax.tree_util.tree_leaves(p8)
    ls = jax.tree_util.tree_leaves(soup)
    assert len(ls) == len(l4)
    for a, b, s in zip(l4, l8, ls):
        assert s.dtype == a.dtype  # original dtype preserved
        want = ((np.asarray(a, np.float32) + np.asarray(b, np.float32)) / 2
                ).astype(a.dtype)
        np.testing.assert_array_equal(np.asarray(s), want)


def test_nonfinite_grads_are_skipped(synth_root, tmp_path):
    """optax.apply_if_finite containment: a poisoned batch must not poison
    params (SURVEY.md §5 failure-detection upgrade)."""
    import optax
    from lstm_unet_tpu.engine.train import make_train_step
    from lstm_unet_tpu.models import ModelConfig, ULSTMnet2D

    cfg = ModelConfig.make(tiny_net_kernel_params())
    params = ULSTMnet2D.init(jax.random.PRNGKey(0), cfg)
    opt = optax.apply_if_finite(optax.adam(1e-3), max_consecutive_errors=10)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt, (1.0, 1.0, 1.0))
    B, T, H, W = 1, 2, 16, 16
    state = ULSTMnet2D.init_state(cfg, B, H, W)
    img = jnp.full((B, T, H, W, 1), jnp.nan)  # poisoned batch
    seg = jnp.zeros((B, T, H, W), jnp.int32)
    ones = jnp.ones((B, T))
    # snapshot to host BEFORE the step: the train step donates params
    before = [np.asarray(l) for l in jax.tree_util.tree_leaves(params)]
    new_params, opt_state, state, m = step(
        params, opt_state, state, img, seg, ones, ones, jnp.zeros((B,)))
    for a, b in zip(before, jax.tree_util.tree_leaves(new_params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_reset_on_jump_recovers_fresh_stream(synth_root, tmp_path):
    """With reset_on_jump, an abrupt scene change zeroes the LSTM state:
    the first frame after the cut produces EXACTLY the fresh-stream output,
    while without the option the stale state leaks through."""
    import numpy as np

    from lstm_unet_tpu.config import CTCInferenceParams, tiny_net_kernel_params
    from lstm_unet_tpu.engine.infer import StreamingInferenceEngine
    from lstm_unet_tpu.io.synthetic import make_cell_sequence
    from lstm_unet_tpu.models import ModelConfig, ULSTMnet2D

    import jax

    cfg = ModelConfig.make(tiny_net_kernel_params())
    params = ULSTMnet2D.init(jax.random.PRNGKey(0), cfg)
    scene_a, _ = make_cell_sequence(num_frames=3, height=32, width=32,
                                    num_cells=3, seed=1)
    scene_b, _ = make_cell_sequence(num_frames=1, height=32, width=32,
                                    num_cells=5, seed=99)
    # scene_b inverted intensity-wise -> large mean frame delta
    frame_b = (60000 - scene_b[0].astype(np.float32))

    def stream(reset_thresh, frames):
        ip = CTCInferenceParams(model_path="", dtype="float32",
                                min_cell_size=2, reset_on_jump=reset_thresh)
        eng = StreamingInferenceEngine(params, cfg, ip)
        out = None
        for f in frames:
            out, _ = eng.process_frame(f.astype(np.float32))
        return out

    fresh = stream(0.0, [frame_b])
    with_reset = stream(0.4, list(scene_a.astype(np.float32)) + [frame_b])
    np.testing.assert_array_equal(with_reset, fresh)


def test_restore_empty_ckpt_dir_starts_fresh(synth_root, tmp_path):
    """continue_run into a dir that never reached its first save (stall
    watchdog fired during first compile, supervisor relaunched) warns and
    trains fresh instead of crashing the retry loop."""
    p = _params(synth_root, tmp_path, dry_run=True)
    t = Trainer(p, seed=0)
    t._restore(str(tmp_path / "never_saved"))
    assert t.global_step == 0


def test_continue_run_num_iterations_is_total_budget(synth_root, tmp_path):
    """Via the config knob, a resumed run trains up to num_iterations TOTAL
    and stops — a supervisor relaunch must not add a full budget per
    restart. Explicit train(num_iterations=K) keeps 'K more steps'."""
    p = _params(synth_root, tmp_path, num_iterations=6,
                save_checkpoint_iteration=3)
    t1 = Trainer(p, seed=0)
    t1.train(num_iterations=3)   # explicit: 3 more steps, saved at step 3
    assert t1.global_step == 3

    p2 = _params(synth_root, tmp_path, num_iterations=6, continue_run=True)
    t2 = Trainer(p2, seed=1)
    assert t2.global_step == 3
    t2.train()                   # config knob: runs only to the total of 6
    assert t2.global_step == 6

    p3 = _params(synth_root, tmp_path, num_iterations=6, continue_run=True)
    t3 = Trainer(p3, seed=2)
    t3.train()                   # already at target: trains 0 steps
    assert t3.global_step == 6


def test_spike_guard_rolls_back_and_aborts_on_recurrence(synth_root, tmp_path,
                                                         capsys):
    """spike_factor < 1 makes every armed step a 'spike': the guard must
    restore the last checkpoint (weights meet NEW data — reader position is
    kept), then abort loudly after spike_max_rollbacks recurrences."""
    p = _params(synth_root, tmp_path, save_checkpoint_iteration=2,
                validation_interval=10**6, spike_factor=0.5, spike_warmup=3,
                spike_cooldown=2, spike_max_rollbacks=2)
    t = Trainer(p, seed=0)
    with pytest.raises(RuntimeError, match="spike guard"):
        t.train(num_iterations=40)
    out = capsys.readouterr().out
    assert out.count("rolling back") >= 2
    assert "restored weights/opt from step" in out
    # the step counter kept moving (no rewind) past warmup + 2 cooldowns
    assert t.global_step > 5


def test_spike_guard_without_checkpoint_warns_and_continues(synth_root,
                                                            tmp_path, capsys):
    """No checkpoint yet: the guard logs and keeps training (an unattended
    run must not crash on a spike it cannot roll back from)."""
    p = _params(synth_root, tmp_path, save_checkpoint_iteration=10**6,
                validation_interval=10**6, spike_factor=0.5, spike_warmup=2,
                spike_cooldown=1, spike_max_rollbacks=10**6)
    t = Trainer(p, seed=0)
    m = t.train(num_iterations=8)
    assert np.isfinite(m["loss"])
    assert "no checkpoint to roll back to" in capsys.readouterr().out


def test_spike_guard_drains_final_step(synth_root, tmp_path, capsys):
    """Lag-1 guard: the last dispatched step is only inspected after the
    loop — a 'spike' there must still roll back BEFORE the final save
    captures the spiked iterate. spike_warmup > n_iter keeps the in-loop
    guard disarmed so only the post-loop drain can fire (factor 0.5 makes
    any steady loss a 'spike' vs its own EMA)."""
    p = _params(synth_root, tmp_path, save_checkpoint_iteration=2,
                validation_interval=10**6, spike_factor=0.5,
                spike_warmup=10**6, spike_cooldown=1, spike_max_rollbacks=5)
    t = Trainer(p, seed=0)
    t.train(num_iterations=6)
    out = capsys.readouterr().out
    assert "SPIKE at final step" in out
    assert "rolling back before the final save" in out
    assert "restored weights/opt from step" in out
    assert out.count("SPIKE") == 1  # the in-loop guard never armed


def test_spike_guard_off_by_default(synth_root, tmp_path, capsys):
    """spike_factor=0 (reference parity): no guard activity at all."""
    p = _params(synth_root, tmp_path, validation_interval=10**6)
    t = Trainer(p, seed=0)
    t.train(num_iterations=6)
    out = capsys.readouterr().out
    assert "SPIKE" not in out and "rolling back" not in out


def test_adam_mu_dtype_bf16_trains(synth_root, tmp_path):
    """adam_mu_dtype='bfloat16' stores Adam's first moment in bf16 (half the
    mu bytes / per-step copy traffic — BASELINE.md r3 training copy bucket)
    while still training: loss decreases, and every mu leaf is bf16 while
    every nu leaf stays f32."""
    p = _params(synth_root, tmp_path, adam_mu_dtype="bfloat16")
    trainer = Trainer(p, seed=0)
    first = trainer.train(num_iterations=2)
    late = trainer.train(num_iterations=60)
    assert late["loss"] < first["loss"], (first, late)

    import optax
    adam_state = [s for s in jax.tree_util.tree_leaves(
        trainer.opt_state, is_leaf=lambda x: isinstance(
            x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert adam_state, "no ScaleByAdamState found in opt_state"
    for s in adam_state:
        for leaf in jax.tree_util.tree_leaves(s.mu):
            assert leaf.dtype == jnp.bfloat16, leaf.dtype
        for leaf in jax.tree_util.tree_leaves(s.nu):
            assert leaf.dtype == jnp.float32, leaf.dtype


def test_compact_upload_is_bit_identical(synth_root, tmp_path):
    """compact_upload (int8 labels + host-side bf16 image pre-cast) must be
    bit-identical to the f32/int32 upload path: the model's first op is
    astype(compute_dtype), and one_hot/compare are label-dtype-independent."""
    losses = {}
    for compact in (True, False):
        p = _params(synth_root, tmp_path / f"c{compact}", dtype="bfloat16",
                    dry_run=True, compact_upload=compact)
        t = Trainer(p, seed=0)
        m = t.train(num_iterations=3)
        losses[compact] = m["loss"]
    assert losses[True] == losses[False]


def test_rss_guard_exits_with_watchdog_code(synth_root, tmp_path, monkeypatch):
    """The host-RSS relaunch guard, when armed, saves and exits 17 (a
    supervisor then relaunches with continue_run — same contract as the
    stall watchdog). It is off by default."""
    import lstm_unet_tpu.engine.train as train_mod

    assert CTCParams().rss_relaunch_gb == 0.0
    monkeypatch.setattr(train_mod, "rss_gb", lambda: 999.0)
    monkeypatch.setattr(train_mod, "_RSS_CHECK_EVERY", 2)
    p = _params(synth_root, tmp_path, dry_run=False,
                experiment_name="rssguard", save_checkpoint_iteration=10000,
                rss_relaunch_gb=90.0)
    t = Trainer(p, seed=0)
    with pytest.raises(SystemExit) as e:
        t.train(num_iterations=10)
    assert e.value.code == 17
    # the finally block ran the final barrier save — the run is resumable
    steps = [d for d in os.listdir(p.experiment_save_dir) if d.isdigit()]
    assert steps, f"no checkpoint saved under {p.experiment_save_dir}"


def test_rss_guard_disabled_runs_to_completion(synth_root, tmp_path,
                                               monkeypatch):
    import lstm_unet_tpu.engine.train as train_mod

    monkeypatch.setattr(train_mod, "rss_gb", lambda: 999.0)
    monkeypatch.setattr(train_mod, "_RSS_CHECK_EVERY", 2)
    p = _params(synth_root, tmp_path, dry_run=True, rss_relaunch_gb=0.0)
    t = Trainer(p, seed=0)
    m = t.train(num_iterations=4)
    assert np.isfinite(m["loss"])
