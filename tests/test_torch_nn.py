"""The port's nn modules against their flax counterparts, on the CPU.

Each case makes its inputs and its params with numpy from a seed (every
leaf nonzero, so zero-initialised projections reach the output), runs the
flax module and the port module, and holds them to <= 1e-5 relative L2 in
float32. The reference runs at `highest` matmul precision with XLA
attention (tests/conftest.py); the port runs its plain versions.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.nn import attention_blocks as jab
from emox.nn import blocks as jblocks
from emox.nn import conditioners as jcond
from emox.nn import embeddings as jemb
from emox_torch.nn import attention_blocks as tab
from emox_torch.nn import blocks as tblocks
from emox_torch.nn import conditioners as tcond
from emox_torch.nn import embeddings as temb
from tests.test_torch_bridge import flax_module_params, no_kernel_launches, rel_err, torch_module  # noqa: F401 (autouse fixture)

TOL = 1e-5  # float32, relative L2


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def check(jmod, tmod, args, kwargs=None, seed=0, tol=TOL):
    """Seeded params for `jmod`, loaded into `tmod`; both applied to the
    same numpy inputs. Returns the two outputs (pytrees of arrays)."""
    kwargs = kwargs or {}
    jargs = [_j(a) if isinstance(a, np.ndarray) else a for a in args]
    jkw = {k: _j(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
    params = flax_module_params(jmod, *jargs, seed=seed, **jkw)
    want = jmod.apply({"params": params}, *jargs, **jkw)
    tmod = torch_module(tmod, params)
    targs = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    tkw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
    with torch.no_grad():
        got = tmod(*targs, **tkw)
    flat_w = want if isinstance(want, (tuple, list)) else [want]
    flat_g = got if isinstance(got, (tuple, list)) else [got]
    for w, g in zip(_flatten(flat_w), _flatten(flat_g)):
        assert tuple(g.shape) == tuple(w.shape)
        assert rel_err(g, np.asarray(w)) <= tol
    return want, got


def _flatten(xs):
    for x in xs:
        if isinstance(x, (tuple, list)):
            yield from _flatten(x)
        else:
            yield x


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---- embeddings -----------------------------------------------------------------
@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 250, 999], np.int32)
    want = jemb.timestep_embedding(_j(t), dim)
    got = temb.timestep_embedding(_t(t.astype(np.int64)), dim)
    assert rel_err(got, np.asarray(want)) <= TOL


def test_sinusoidal_positions():
    for max_len, dim in [(24, 16), (24, 10), (8, 7)]:
        want = jemb.sinusoidal_positions(max_len, dim)
        assert rel_err(temb.sinusoidal_positions(max_len, dim), np.asarray(want)) <= TOL


def test_timestep_embedder():
    t = np.array([3, 500, 981], np.int64)
    check(jemb.TimestepEmbedder(dim=32, sinusoidal_dim=8), temb.TimestepEmbedder(32, 8), [t])


# ---- blocks -----------------------------------------------------------------------
def test_fold_unfold_time():
    x = torch.arange(2 * 3 * 4 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 4, 5)
    folded, t = tblocks.fold_time(x)
    assert t == 3 and folded.shape == (6, 4, 4, 5)
    assert torch.equal(tblocks.unfold_time(folded, t), x)
    np.testing.assert_array_equal(folded.numpy(), np.asarray(jblocks.fold_time(_j(x.numpy()))[0]))
    assert tblocks.fold_time(folded)[1] == 1


@pytest.mark.parametrize("silu", [False, True])
def test_fused_group_norm(silu):
    rng = np.random.default_rng(0)
    x = randn(rng, 2, 3, 6, 6, 16, scale=2.0) + 0.5
    check(jblocks.FusedGroupNorm(groups=4, silu=silu), tblocks.FusedGroupNorm(16, groups=4, silu=silu), [x])


@pytest.mark.parametrize(
    "temb_mode,per_frame,cin",
    [("scale_shift", False, 8), ("scale_shift", True, 16), ("add", False, 16), ("add", True, 8)],
    ids=["scale_shift", "scale_shift_per_frame_skip", "add", "add_per_frame_skip"],
)
def test_resblock(temb_mode, per_frame, cin):
    """5-D video input; temb per clip [B, D] or per frame [(B T), D]; cin !=
    cout builds the 1x1 skip."""
    rng = np.random.default_rng(1)
    b, t = 2, 3
    x = randn(rng, b, t, 6, 6, cin)
    te = randn(rng, b * t if per_frame else b, 12)
    check(jblocks.ResBlock(16, groups=4, temb_mode=temb_mode),
          tblocks.ResBlock(cin, 16, groups=4, temb_dim=12, temb_mode=temb_mode), [x, te])


def test_resblock_without_temb():
    rng = np.random.default_rng(2)
    x = randn(rng, 2, 6, 6, 8)
    check(jblocks.ResBlock(8, groups=4), tblocks.ResBlock(8, 8, groups=4), [x])


@pytest.mark.parametrize("padding,size", [("unet", 8), ("SAME", 8), ("SAME", 7)])
def test_downsample(padding, size):
    """The UNet's explicit ((1, 1), (1, 1)) and flax "SAME", which pads a
    stride-2 3x3 on an even size by (0, 1)."""
    rng = np.random.default_rng(3)
    x = randn(rng, 2, 2, size, size, 8)
    pad = ((1, 1), (1, 1)) if padding == "unet" else padding
    check(jblocks.Downsample(12, padding=pad), tblocks.Downsample(8, 12, padding=pad), [x])


def test_upsample():
    rng = np.random.default_rng(4)
    x = randn(rng, 2, 2, 4, 5, 8)
    check(jblocks.Upsample(8), tblocks.Upsample(8, 8), [x])


def test_nearest_resize_is_repeat_interleave():
    """jax.image.resize(..., "nearest") x2 repeats each pixel 2x2."""
    import jax

    x = np.random.default_rng(5).standard_normal((2, 3, 5, 4)).astype(np.float32)
    want = jax.image.resize(_j(x), (2, 6, 10, 4), method="nearest")
    rep = _t(x).repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    np.testing.assert_array_equal(np.asarray(want), rep.numpy())
    np.testing.assert_array_equal(tblocks.upsample_nearest2x(_t(x)).numpy(), rep.numpy())


# ---- conditioners -------------------------------------------------------------------
@pytest.mark.parametrize("axes", [1, 3])
def test_speed_encoder(axes):
    rng = np.random.default_rng(6)
    speeds = (rng.uniform(-1.2, 1.2, (5, axes))).astype(np.float32)
    if axes == 1:
        speeds = speeds[:, 0]
    check(jcond.SpeedEncoder(dim=16), tcond.SpeedEncoder(16, axes=axes), [speeds])


@pytest.mark.parametrize("size", [32, 24])
def test_face_mask_encoder(size):
    rng = np.random.default_rng(7)
    mask = (rng.uniform(size=(2, size, size, 1)) > 0.5).astype(np.float32)
    check(jcond.FaceMaskEncoder(out_channels=8), tcond.FaceMaskEncoder(8), [mask])


# ---- attention blocks -----------------------------------------------------------------
def test_attention_self_and_bias():
    rng = np.random.default_rng(8)
    x = randn(rng, 3, 10, 16)
    check(jab.Attention(heads=2, head_dim=8), tab.Attention(16, 2, 8), [x])
    check(jab.Attention(heads=1, head_dim=16, qkv_bias=True, out_dim=12),
          tab.Attention(16, 1, 16, out_dim=12, qkv_bias=True), [x])


def test_attention_context_tile():
    """Per-clip context projected once and repeated per frame."""
    rng = np.random.default_rng(9)
    x = randn(rng, 6, 10, 16)
    ctx = randn(rng, 2, 5, 12)
    check(jab.Attention(heads=2, head_dim=8), tab.Attention(16, 2, 8, context_dim=12), [x],
          dict(context=ctx, context_tile=3))


def test_attention_extra_kv_tile_drop():
    """Reference tokens projected once, repeated per frame (extra_tile); the
    dropped rows use their own tokens in place of the reference ones."""
    rng = np.random.default_rng(10)
    b, t, l, c = 2, 3, 10, 16
    x = randn(rng, b * t, l, c)
    ref = randn(rng, b, l, c)
    drop = np.repeat(np.array([True, False]), t)
    check(jab.Attention(heads=2, head_dim=8), tab.Attention(c, 2, 8), [x],
          dict(extra_kv=ref, extra_tile=t, extra_drop=drop))
    # without drop: K/V = own tokens then the repeated reference tokens
    check(jab.Attention(heads=2, head_dim=8), tab.Attention(c, 2, 8), [x],
          dict(extra_kv=ref, extra_tile=t), seed=1)


def test_attention_extra_drop_needs_equal_lengths():
    att = tab.Attention(8, 1, 8)
    for p in att.parameters():
        torch.nn.init.normal_(p)
    with pytest.raises(ValueError, match="equal token counts"):
        att(torch.zeros(2, 4, 8), extra_kv=torch.zeros(2, 5, 8), extra_drop=torch.tensor([True, False]))


def test_geglu_feed_forward():
    rng = np.random.default_rng(11)
    x = randn(rng, 2, 7, 16)
    check(jab.GEGLUFeedForward(), tab.GEGLUFeedForward(16), [x])


@pytest.mark.parametrize("use_cross", [False, True])
def test_transformer_block(use_cross):
    """Self-attention with reference K/V and CFG drop rows, optional text
    cross-attention, fused FF sub-layer; returns (x, normed1)."""
    rng = np.random.default_rng(12)
    b, t, l, c = 2, 2, 9, 16
    x = randn(rng, b * t, l, c)
    kw = dict(ref_kv=randn(rng, b, l, c), ref_drop=np.array([True, True, False, False]), ref_tile=t)
    if use_cross:
        kw.update(context=randn(rng, b, 4, 12), ctx_tile=t)
    check(jab.TransformerBlock(heads=2, head_dim=8, use_cross=use_cross),
          tab.TransformerBlock(c, 2, 8, use_cross=use_cross, cross_dim=12), [x], kw)


@pytest.mark.parametrize("with_ref", [False, True])
def test_spatial_transformer(with_ref):
    rng = np.random.default_rng(13)
    b, t, h, w, c = 2, 2, 3, 4, 16
    x = randn(rng, b * t, h, w, c)
    jm = jab.SpatialTransformer(heads=2, head_dim=8, depth=2, groups=4, use_cross=False, num_frames=t)
    tm = tab.SpatialTransformer(c, 2, 8, depth=2, groups=4, use_cross=False)
    kw = {}
    if with_ref:
        kw = dict(ref_kv=[randn(rng, b, h * w, c), randn(rng, b, h * w, c)],
                  ref_drop=np.array([False, False, True, True]))
    jargs = [_j(x)]
    jkw = {k: ([_j(a) for a in v] if isinstance(v, list) else _j(v)) for k, v in kw.items()}
    params = flax_module_params(jm, *jargs, **jkw)
    want, want_banks = jm.apply({"params": params}, *jargs, **jkw)
    tm = torch_module(tm, params)
    tkw = {k: ([_t(a) for a in v] if isinstance(v, list) else _t(v)) for k, v in kw.items()}
    with torch.no_grad():
        got, banks = tm(_t(x), num_frames=t, **tkw)
    assert rel_err(got, np.asarray(want)) <= TOL
    assert len(banks) == len(want_banks) == 2
    for g, w in zip(banks, want_banks):
        assert rel_err(g, np.asarray(w)) <= TOL


def test_frame_axis_attention():
    rng = np.random.default_rng(14)
    x = randn(rng, 2, 5, 6, 16)
    check(jab.FrameAxisAttention(heads=2, head_dim=8), tab.FrameAxisAttention(16, 2, 8), [x])


@pytest.mark.parametrize("depth", [1, 2])
def test_temporal_transformer(depth):
    rng = np.random.default_rng(15)
    x = randn(rng, 2, 5, 3, 3, 16)
    check(jab.TemporalTransformer(heads=2, head_dim=8, depth=depth, max_len=8),
          tab.TemporalTransformer(16, 2, 8, depth=depth, max_len=8), [x])


def test_audio_cross_attention():
    rng = np.random.default_rng(16)
    x = randn(rng, 2, 3, 4, 4, 16)
    audio = randn(rng, 2, 3, 5, 12)
    check(jab.AudioCrossAttention(heads=2, head_dim=8), tab.AudioCrossAttention(16, 2, 8, 12), [x, audio])
