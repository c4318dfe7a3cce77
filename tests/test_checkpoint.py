"""Step checkpoints (checkpoint/ckpt.py): npz archives + JSON manifest."""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest

from lstm_unet_tpu.checkpoint import CheckpointManager, average_checkpoints
from lstm_unet_tpu.checkpoint.ckpt import save_model_params


def _trees(v: float):
    params = {"enc": [{"kernel": jnp.full((3, 3, 1, 4), v, jnp.float32),
                       "bias": jnp.arange(4, dtype=jnp.float32) + v}],
              "head": {"w": jnp.full((2,), v, jnp.bfloat16)}}
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    return params, opt.init(params)


def _abstract(tree):
    return jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)


def test_save_restore_round_trip(tmp_path):
    params, opt_state = _trees(1.5)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, params, opt_state)
    mgr.wait()
    p2, o2, step = mgr.restore(_abstract(params), _abstract(opt_state))
    assert step == 7 and mgr.latest_step() == 7
    for a, b in zip(jax.tree_util.tree_leaves((params, opt_state)),
                    jax.tree_util.tree_leaves((p2, o2))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert p2["head"]["w"].dtype == jnp.bfloat16  # stored as raw bits
    assert jax.tree_util.tree_structure(o2) == \
        jax.tree_util.tree_structure(opt_state)
    # no partial directory is left behind
    assert sorted(os.listdir(tmp_path)) == ["7"]
    mgr.close()


def test_max_to_keep_prunes_oldest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, *_trees(float(s)))
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert sorted(d for d in os.listdir(tmp_path)) == ["3", "4"]
    mgr.close()


def test_restore_params_only_flat_and_structured(tmp_path):
    params, opt_state = _trees(2.0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, params, opt_state)
    mgr.save(5, params)  # params-only checkpoint
    flat = mgr.restore_params_only(step=3)
    assert set(flat) == {"enc/0/kernel", "enc/0/bias", "head/w"}
    assert flat["head/w"].dtype == ml_dtypes.bfloat16
    p = mgr.restore_params_only(_abstract(params))  # latest = 5
    np.testing.assert_array_equal(np.asarray(p["enc"][0]["bias"]),
                                  np.asarray(params["enc"][0]["bias"]))
    with pytest.raises(KeyError, match="opt_state"):
        mgr.restore(_abstract(params), _abstract(opt_state), step=5)
    with pytest.raises(ValueError, match="shape"):
        bad = dict(params, head={"w": jax.ShapeDtypeStruct((3,), jnp.bfloat16)})
        mgr.restore_params_only(_abstract(bad))
    mgr.close()


def test_async_save_copies_to_host_before_returning(tmp_path):
    """save() snapshots the arrays: a donated/overwritten device buffer
    after save() returns must not change what lands on disk."""
    mgr = CheckpointManager(str(tmp_path))
    params = {"w": jnp.ones((64, 64), jnp.float32)}
    mgr.save(1, params)
    params["w"].delete()  # the caller's buffer is gone (e.g. donated)
    mgr.wait()
    got = mgr.restore_params_only(step=1)
    np.testing.assert_array_equal(got["w"], np.ones((64, 64), np.float32))
    mgr.close()


def test_average_checkpoints_is_numpy_only_soup(tmp_path):
    src = tmp_path / "run"
    save_model_params(str(src), {"model_config": {}})
    mgr = CheckpointManager(str(src))
    for s, v in ((10, 1.0), (20, 3.0), (30, 100.0)):
        mgr.save(s, *_trees(v))
    mgr.close()
    out = tmp_path / "soup"
    assert average_checkpoints(str(src), str(out), steps=[10, 20]) == 20
    assert os.path.exists(out / "model_params.json")
    avg = CheckpointManager(str(out)).restore_params_only()
    np.testing.assert_array_equal(avg["enc/0/kernel"],
                                  np.full((3, 3, 1, 4), 2.0, np.float32))
    assert avg["head/w"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(avg["head/w"].astype(np.float32),
                                  np.full((2,), 2.0, np.float32))
