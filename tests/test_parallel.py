"""Multi-chip tests on the 8-virtual-device CPU mesh (SURVEY.md §4):
pjit/mesh paths, dp+sp sharded train step, sharded-vs-single-device parity,
and the driver contract in __graft_entry__.py."""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lstm_unet_tpu.config import tiny_net_kernel_params
from lstm_unet_tpu.models import ModelConfig, ULSTMnet2D
from lstm_unet_tpu.parallel import make_mesh, data_sharding, shard_batch


def test_make_mesh_shapes():
    mesh = make_mesh({"data": 4, "spatial": 2})
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("data", "spatial")
    with pytest.raises(ValueError):
        make_mesh({"data": 100})


def test_sharded_forward_matches_single_device():
    """dp+sp sharded forward == unsharded forward (numerics preserved)."""
    cfg = ModelConfig.make(tiny_net_kernel_params())
    params = ULSTMnet2D.init(jax.random.PRNGKey(0), cfg)
    B, T, H, W = 4, 2, 32, 32
    x = jax.random.normal(jax.random.PRNGKey(1), (B, T, H, W, 1))
    state = ULSTMnet2D.init_state(cfg, B, H, W)

    _, ref = ULSTMnet2D.apply(params, state, x, cfg)

    mesh = make_mesh({"data": 4, "spatial": 2})
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None, "spatial")))
    ss = jax.device_put(state, NamedSharding(mesh, P("data", "spatial")))
    ps = jax.device_put(params, NamedSharding(mesh, P()))
    with mesh:
        _, out = jax.jit(
            lambda p, s, xx: ULSTMnet2D.apply(p, s, xx, cfg))(ps, ss, xs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)


def test_graft_entry_single_chip_traces():
    """Trace + lower the flagship entry (execution belongs on the card;
    running the full-size model on a CPU test host would take minutes)."""
    import __graft_entry__ as g

    fn, args = g.entry()
    lowered = jax.jit(fn).lower(*args)
    out_state_shape, logits_shape = jax.eval_shape(fn, *args)
    assert logits_shape.shape == (1, 256, 256, 3)


def test_graft_entry_dryrun_multichip(monkeypatch):
    import __graft_entry__ as g

    # fast mode: the flagship-scale stages (subprocess, several minutes on
    # this 1-core host) are the driver's job; tests pin the tiny-net path
    monkeypatch.setenv("GRAFT_DRYRUN_FAST", "1")
    g.dryrun_multichip(8)
    g.dryrun_multichip(4)


def test_halo_conv_matches_unsharded():
    """Explicit ppermute halo-exchange conv == plain SAME conv (SURVEY.md §2
    SP/CP row — the spatial-parallel path)."""
    from lstm_unet_tpu.ops.conv import conv2d, init_conv
    from lstm_unet_tpu.parallel.halo import halo_conv2d

    mesh = make_mesh({"spatial": 4})
    p = init_conv(jax.random.PRNGKey(0), 5, 3, 8, 16)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 32, 24, 8))
    ref = conv2d(x, p["kernel"], p["bias"])
    xs = jax.device_put(x, NamedSharding(mesh, P(None, "spatial")))
    out = halo_conv2d(xs, p["kernel"], p["bias"], mesh=mesh)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)


def test_trainer_dp_sp_mesh_matches_single_device(tmp_path):
    """A Trainer given mesh_shape={'data':2,'spatial':4} must reproduce the
    single-device loss trajectory — the engine-native dp+sp training step
    (VERDICT r2 weak #3: spatial used to silently replicate in the
    Trainer; only dryrun_multichip hand-built this placement)."""
    from lstm_unet_tpu.config import CTCParams
    from lstm_unet_tpu.engine.train import Trainer
    from lstm_unet_tpu.io.synthetic import write_ctc_dataset
    from lstm_unet_tpu.parallel import shard_state

    root = str(tmp_path / "ctc")
    write_ctc_dataset(root, num_frames=8, height=48, width=48, num_cells=3,
                      seed=11)

    def make(mesh_shape):
        p = CTCParams(
            root_data_dir=root,
            train_sequence_list=[("Synth-N2DH-SIM", "01")],
            crop_size=(32, 32), batch_size=2, unroll_len=2,
            net_kernel_params=tiny_net_kernel_params(), learning_rate=1e-3,
            dry_run=True, num_prefetch_threads=1,
            validation_interval=10**6, save_checkpoint_iteration=10**6,
            print_to_console_interval=10**6, write_to_tb_interval=10**6,
            mesh_shape=mesh_shape)
        return Trainer(p, seed=3)

    # identical reader seeds -> identical batch streams (thread-count- and
    # sharding-invariant); compare per-step losses
    losses = {}
    for tag, mesh_shape in (("single", {}), ("dp_sp", {"data": 2, "spatial": 4})):
        t = make(mesh_shape)
        if tag == "dp_sp":
            assert t.mesh is not None
            # 32 % (4 * 2^depth) == 0 for the tiny net -> state h really
            # shards over 'spatial' (the test would pass vacuously if the
            # engine silently replicated, so pin the placement itself)
            st = shard_state(t.mesh, t._fresh_state())
            leaf = jax.tree_util.tree_leaves(st)[0]
            assert "spatial" in str(leaf.sharding.spec)
        run = []
        t.reader.start_queues()
        state = t._fresh_state()
        try:
            for _ in range(4):
                img, seg, valid, full_seg, is_last = t._put(
                    t.reader.get_batch())
                (t.model_params, t.opt_state, state, m) = t.step_fn(
                    t.model_params, t.opt_state, state, img, seg, valid,
                    full_seg, is_last)
                run.append(float(m["loss"]))
        finally:
            t.reader.stop()
        losses[tag] = run
    np.testing.assert_allclose(losses["dp_sp"], losses["single"], rtol=2e-4)


def test_int8_sharded_forward_matches_single_device():
    """int8 quantized step under dp+sp sharding == single-device int8 step.

    The dynamic per-tensor activation scale is a GLOBAL abs-max reduce —
    under spatial sharding XLA must all-reduce it (not per-shard maxes), or
    lanes quantize on different grids and logits drift; this pins that."""
    from lstm_unet_tpu.ops.quant import quantize_params_int8

    cfg = ModelConfig.make(tiny_net_kernel_params(), quant="int8")
    params = ULSTMnet2D.init(jax.random.PRNGKey(0), cfg)
    qparams = quantize_params_int8(params)
    B, H, W = 4, 32, 32
    x = jax.random.normal(jax.random.PRNGKey(1), (B, H, W, 1))
    state = ULSTMnet2D.init_state(cfg, B, H, W)

    _, ref = jax.jit(
        lambda p, s, xx: ULSTMnet2D.step(p, s, xx, cfg))(qparams, state, x)

    mesh = make_mesh({"data": 4, "spatial": 2})
    xs = jax.device_put(x, NamedSharding(mesh, P("data", "spatial")))
    ss = jax.device_put(state, NamedSharding(mesh, P("data", "spatial")))
    ps = jax.device_put(qparams, NamedSharding(mesh, P()))
    with mesh:
        _, out = jax.jit(
            lambda p, s, xx: ULSTMnet2D.step(p, s, xx, cfg))(ps, ss, xs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)
