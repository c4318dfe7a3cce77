"""Model tests (SURVEY.md §4):

- shape contract over net_kernel_params-driven topologies
- THE core stateful-inference invariant: streaming N frames one-at-a-time
  ≡ one batched unroll of N frames (reference behavior contract §8.4)
- per-lane state reset correctness (reference reset_states_per_batch)
- gradient flow through BPTT
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lstm_unet_tpu.config import NetKernelParams, tiny_net_kernel_params
from lstm_unet_tpu.models import ModelConfig, ULSTMnet2D


def _mk(cfg_kw=None):
    cfg = ModelConfig.make(tiny_net_kernel_params(), **(cfg_kw or {}))
    params = ULSTMnet2D.init(jax.random.PRNGKey(0), cfg)
    return cfg, params


def test_forward_shapes():
    cfg, params = _mk()
    B, T, H, W = 2, 3, 16, 24
    state = ULSTMnet2D.init_state(cfg, B, H, W)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, T, H, W, 1))
    state2, logits = ULSTMnet2D.apply(params, state, x, cfg)
    assert logits.shape == (B, T, H, W, 3)
    # state shapes preserved
    for a, b in zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(state2)):
        assert a.shape == b.shape


def test_bad_input_size_raises():
    cfg, params = _mk()
    with pytest.raises(ValueError):
        ULSTMnet2D.init_state(cfg, 1, 18, 16)  # 18 not divisible by 4


def test_streaming_equals_batched_unroll():
    """Streaming one frame at a time == one unrolled scan (SURVEY.md §8.4)."""
    cfg, params = _mk()
    B, T, H, W = 1, 5, 16, 16
    x = jax.random.normal(jax.random.PRNGKey(2), (B, T, H, W, 1))

    state = ULSTMnet2D.init_state(cfg, B, H, W)
    _, batched = ULSTMnet2D.apply(params, state, x, cfg)

    state = ULSTMnet2D.init_state(cfg, B, H, W)
    step = jax.jit(lambda s, f: ULSTMnet2D.step(params, s, f, cfg))
    outs = []
    for t in range(T):
        state, logits = step(state, x[:, t])
        outs.append(logits)
    streamed = jnp.stack(outs, axis=1)
    np.testing.assert_allclose(np.asarray(batched), np.asarray(streamed),
                               atol=1e-5, rtol=1e-5)


def test_state_carry_matters():
    """Carrying state across windows must change the output (recurrence real)."""
    cfg, params = _mk()
    B, H, W = 1, 16, 16
    x = jax.random.normal(jax.random.PRNGKey(3), (B, 4, H, W, 1))
    s0 = ULSTMnet2D.init_state(cfg, B, H, W)
    s_mid, _ = ULSTMnet2D.apply(params, s0, x, cfg)
    _, with_carry = ULSTMnet2D.apply(params, s_mid, x, cfg)
    _, without_carry = ULSTMnet2D.apply(params, s0, x, cfg)
    assert not np.allclose(np.asarray(with_carry), np.asarray(without_carry))


def test_reset_lanes():
    cfg, params = _mk()
    B, H, W = 3, 16, 16
    x = jax.random.normal(jax.random.PRNGKey(4), (B, 2, H, W, 1))
    state = ULSTMnet2D.init_state(cfg, B, H, W)
    state, _ = ULSTMnet2D.apply(params, state, x, cfg)
    is_last = jnp.asarray([1.0, 0.0, 1.0])
    reset = ULSTMnet2D.reset_lanes(state, is_last)
    for leaf_r, leaf_s in zip(jax.tree_util.tree_leaves(reset),
                              jax.tree_util.tree_leaves(state)):
        assert np.all(np.asarray(leaf_r[0]) == 0)
        assert np.all(np.asarray(leaf_r[2]) == 0)
        np.testing.assert_array_equal(np.asarray(leaf_r[1]), np.asarray(leaf_s[1]))


def test_gradients_flow_and_finite():
    cfg, params = _mk()
    B, T, H, W = 2, 3, 16, 16
    x = jax.random.normal(jax.random.PRNGKey(5), (B, T, H, W, 1))
    state = ULSTMnet2D.init_state(cfg, B, H, W)

    def loss_fn(p):
        _, logits = ULSTMnet2D.apply(p, state, x, cfg, remat=True)
        return jnp.mean(logits ** 2)

    grads = jax.grad(loss_fn)(params)
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(np.all(np.isfinite(np.asarray(l))) for l in leaves)
    # every parameter (incl. deepest lstm + head) receives gradient signal
    nonzero = [float(jnp.max(jnp.abs(l))) > 0 for l in leaves]
    assert all(nonzero)


def test_remat_policies_identical_loss_and_grads():
    """remat=False / True / 'save_outputs' are pure scheduling choices —
    loss and gradients must agree to float tolerance (the selective policy
    saves the checkpoint_name'd lstm/skip tensors and recomputes the rest)."""
    cfg, params = _mk()
    B, T, H, W = 2, 3, 16, 16
    x = jax.random.normal(jax.random.PRNGKey(5), (B, T, H, W, 1))
    state = ULSTMnet2D.init_state(cfg, B, H, W)

    def loss_fn(p, remat):
        _, logits = ULSTMnet2D.apply(p, state, x, cfg, remat=remat)
        return jnp.mean(logits ** 2)

    ref_l, ref_g = jax.value_and_grad(lambda p: loss_fn(p, False))(params)
    for remat in (True, "save_outputs"):
        l, g = jax.value_and_grad(lambda p: loss_fn(p, remat))(params)
        np.testing.assert_allclose(float(l), float(ref_l), rtol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(g),
                        jax.tree_util.tree_leaves(ref_g)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-6, rtol=1e-5)


def test_layernorm_option():
    cfg = ModelConfig.make(tiny_net_kernel_params(), norm="layernorm")
    params = ULSTMnet2D.init(jax.random.PRNGKey(0), cfg)
    assert "ln_scale" in params["encoder"][0]["convs"][0]
    B, T, H, W = 1, 2, 16, 16
    state = ULSTMnet2D.init_state(cfg, B, H, W)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, T, H, W, 1))
    _, logits = ULSTMnet2D.apply(params, state, x, cfg)
    assert logits.shape == (B, T, H, W, 3)
    assert np.all(np.isfinite(np.asarray(logits)))
    with pytest.raises(ValueError):
        ULSTMnet2D.init(jax.random.PRNGKey(0),
                        ModelConfig.make(tiny_net_kernel_params(), norm="batch"))


def test_multiple_lstm_layers_per_level():
    """net_kernel_params allows stacked ConvLSTMs within one encoder level."""
    nkp = NetKernelParams(
        lstm_kernels=[[(3, 4), (3, 6)], [(3, 8)]],
        down_conv_kernels=[[(3, 8)], [(3, 8)]],
        up_conv_kernels=[[(3, 8)], [(3, 8)]],
    )
    cfg = ModelConfig.make(nkp)
    params = ULSTMnet2D.init(jax.random.PRNGKey(0), cfg)
    assert len(params["encoder"][0]["lstm"]) == 2
    B, T, H, W = 1, 2, 16, 16
    state = ULSTMnet2D.init_state(cfg, B, H, W)
    assert state[0][0][0].shape[-1] == 4 and state[0][1][0].shape[-1] == 6
    new_state, logits = ULSTMnet2D.apply(
        params, state, jax.random.normal(jax.random.PRNGKey(1), (B, T, H, W, 1)), cfg)
    assert logits.shape == (B, T, H, W, 3)


def test_long_streaming_is_o1_and_finite():
    """O(1)-memory unbounded streaming (SURVEY.md §8.4): state shape is
    constant and outputs stay finite over a long stateful run."""
    cfg, params = _mk()
    B, H, W = 1, 16, 16
    state = ULSTMnet2D.init_state(cfg, B, H, W)
    shapes0 = [l.shape for l in jax.tree_util.tree_leaves(state)]
    step = jax.jit(lambda s, f: ULSTMnet2D.step(params, s, f, cfg),
                   donate_argnums=(0,))
    x = jax.random.normal(jax.random.PRNGKey(7), (B, H, W, 1))
    for _ in range(200):
        state, logits = step(state, x)
    leaves = jax.tree_util.tree_leaves(state)
    assert [l.shape for l in leaves] == shapes0
    assert all(np.all(np.isfinite(np.asarray(l))) for l in leaves)
    assert np.all(np.isfinite(np.asarray(logits)))


def test_f32_state_under_bf16_compute():
    """state_dtype='float32' keeps the carry in f32 under bf16 compute and
    stays close to the full-f32 reference."""
    nkp = tiny_net_kernel_params()
    cfg = ModelConfig.make(nkp, dtype="bfloat16", state_dtype="float32")
    params = ULSTMnet2D.init(jax.random.PRNGKey(0), cfg)
    B, T, H, W = 1, 4, 16, 16
    state = ULSTMnet2D.init_state(cfg, B, H, W)
    assert all(l.dtype == jnp.float32
               for l in jax.tree_util.tree_leaves(state))
    x = jax.random.normal(jax.random.PRNGKey(1), (B, T, H, W, 1))
    new_state, logits = ULSTMnet2D.apply(params, state, x, cfg)
    assert all(l.dtype == jnp.float32
               for l in jax.tree_util.tree_leaves(new_state))

    cfg32 = ModelConfig.make(nkp, dtype="float32")
    s32 = ULSTMnet2D.init_state(cfg32, B, H, W)
    _, ref = ULSTMnet2D.apply(params, s32, x, cfg32)
    np.testing.assert_allclose(np.asarray(logits), np.asarray(ref), atol=0.15)


def test_cast_params_for_inference_excludes_layernorm():
    from lstm_unet_tpu.models.ulstm_unet import cast_params_for_inference

    cfg = ModelConfig.make(tiny_net_kernel_params(), norm="layernorm",
                           dtype="bfloat16")
    params = ULSTMnet2D.init(jax.random.PRNGKey(0), cfg)
    cast = cast_params_for_inference(params, jnp.bfloat16)
    conv0 = cast["encoder"][0]["convs"][0]
    assert conv0["kernel"].dtype == jnp.bfloat16
    assert conv0["ln_scale"].dtype == jnp.float32  # norm params stay f32
    assert conv0["ln_bias"].dtype == jnp.float32
    # outputs identical to uncast params (conv2d casts per call anyway)
    B, T, H, W = 1, 2, 16, 16
    s = ULSTMnet2D.init_state(cfg, B, H, W)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, T, H, W, 1))
    _, a = ULSTMnet2D.apply(params, s, x, cfg)
    _, b = ULSTMnet2D.apply(cast, s, x, cfg)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
