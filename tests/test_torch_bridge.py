"""The weight bridge: emox's flax param trees -> emox_torch's state dicts.

Also holds the helpers the other port tests share: param trees made from
the reference's own param shapes (jax.eval_shape of EMOModel.init_params,
no initialiser is run) filled with seeded numpy values, every leaf
nonzero so that zero-initialised branches reach the outputs.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

from emox.core import presets as jpresets
from emox.models.emo import EMOModel as JEMOModel
from emox_torch import ops
from emox_torch.core import presets as tpresets
from emox_torch.interop.from_flax import OPTIONAL_SUBMODELS, SUBMODELS, from_flax, load_flax, load_module
from emox_torch.models.emo import EMOModel

IMAGE, FRAMES = 32, 2


@pytest.fixture(autouse=True)
def no_kernel_launches():
    """CPU tensors never launch a kernel: the counters stay at zero. The
    other port test modules import this fixture, which makes it autouse
    there too."""
    ops.reset_launch_counts()
    yield
    counts = ops.launch_counts()
    assert set(counts) == {"flash_attn_fwd", "flash_attn_bwd", "flash_attn_nlc_fwd", "flash_attn_nlc_bwd", "flash_fwd_sm90",
                           "flash_fwd_f32_sm90", "flash_fwd_d512_f32", "flash_fwd_wide", "flash_bwd_sm90",
                           "flash_bwd_f32_sm90", "flash_bwd_d256_sm90", "flash_bwd_d512_sm90", "flash_bwd_d512_f32",
                           "flash_bwd_wide", "ln_geglu_ff",
                           "geglu_ff", "ff_sm90", "ff_f32_sm90", "group_norm", "group_norm_stats", "ln_qkv",
                           "ln_qkv_sm90", "ln_qkv_f32_sm90"}
    assert not any(counts.values()), counts


# the SD-1.5 head layout's overrides (flagship-sd15: attention_heads=8,
# resnet_temb_mode="add", use_cross_attention=True, clip.text_enabled=True)
# at tiny widths: 2 heads of dim 8, a 2-layer CLIP text encoder as wide as
# the cross-attention context, the real CLIP vocabulary size (the tokenizer's
# ids go up to 49407)
SD15_MODEL = dict(attention_heads=2, resnet_temb_mode="add", use_cross_attention=True, cross_attention_dim=16)
SD15_CLIP = dict(text_enabled=True, vocab_size=49408, text_hidden_dim=16, text_layers=2, text_heads=2,
                 max_positions=24)


# the side models at tiny widths: the ControlNet, and a CLIP vision encoder
# of 2 layers, width 64, 4 heads, image 28 (so the reference image shrinks
# to it), patch 14 and projection 32 feeding the identity embedding
SIDE_MODEL = dict(use_controlnet=True, use_identity_embed=True)
SIDE_CLIP = dict(vision_enabled=True, vision_hidden_dim=64, vision_layers=2, vision_heads=4, image_size=28,
                 patch_size=14, projection_dim=32)


def configs(name: str):
    """(reference Config, port Config) for 'tiny', 'tiny_sd15' (tiny with
    the SD-1.5 head layout and a CLIP text encoder), 'tiny_side' (tiny with
    the side models: ControlNet, CLIP vision and the identity embedding) or
    'small_flag' (small with the flagship's options: no text
    cross-attention, 3-axis speeds)."""
    if name == "tiny":
        return jpresets.tiny_config(IMAGE, FRAMES), tpresets.tiny_config(IMAGE, FRAMES)
    if name in ("tiny_sd15", "tiny_side"):
        model, clip = (SD15_MODEL, SD15_CLIP) if name == "tiny_sd15" else (SIDE_MODEL, SIDE_CLIP)
        return tuple(c.replace(model=dataclasses.replace(c.model, **model), clip=dataclasses.replace(c.clip, **clip))
                     for c in (jpresets.tiny_config(IMAGE, FRAMES), tpresets.tiny_config(IMAGE, FRAMES)))
    jc, tc = jpresets.small_config(IMAGE, FRAMES), tpresets.small_config(IMAGE, FRAMES)
    flags = dict(use_cross_attention=False, speed_axes=3)
    return (jc.replace(model=dataclasses.replace(jc.model, **flags)),
            tc.replace(model=dataclasses.replace(tc.model, **flags)))


def random_flax_params(shapes, seed: int = 0):
    """Seeded numpy values on a tree of ShapeDtypeStructs: kernels
    lecun-normal, norm scales 1 + N(0, 0.1), biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", str(path[-1]))
        if name == "kernel":
            v = rng.standard_normal(s.shape) / math.sqrt(math.prod(s.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "bias":
            v = 0.1 * rng.standard_normal(s.shape)
        else:
            v = 0.02 * rng.standard_normal(s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def model_params(name: str, seed: int = 0):
    """(reference EMOModel, its param tree, port config) for a preset name;
    cached per process, so callers must not modify the tree."""
    jcfg, tcfg = configs(name)
    jm = JEMOModel(jcfg)
    shapes = jax.eval_shape(lambda k: jm.init_params(k, num_frames=FRAMES, image_size=IMAGE),
                            jax.random.PRNGKey(0))
    return jm, random_flax_params(shapes, seed), tcfg


def flax_module_params(module, *args, seed: int = 0, **kwargs):
    """Seeded params of one flax module at the shapes its init would give."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs), jax.random.PRNGKey(0))
    return random_flax_params(shapes, seed)["params"]


def torch_module(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load a flax param tree into a port module (strict) and return it."""
    load_module(module, params)
    return module.eval()


def rel_err(got, want) -> float:
    got = np.asarray(got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


@pytest.fixture(scope="module", params=["tiny", "small_flag", "tiny_sd15", "tiny_side"])
def bundle(request):
    return (request.param, *model_params(request.param))


def _submodels(name: str):
    return SUBMODELS + {"tiny_sd15": ("clip_text",), "tiny_side": ("controlnet", "clip_vision")}.get(name, ())


def test_from_flax_maps_every_leaf(bundle):
    name, _, params, _ = bundle
    state = from_flax(params)
    subs = _submodels(name)
    assert set(state) == set(subs) and set(OPTIONAL_SUBMODELS) >= set(subs) - set(SUBMODELS)
    for sub in subs:
        assert len(state[sub]) == len(list(_leaf_paths(params[sub]))), sub


def test_load_sets_every_port_parameter(bundle):
    """Strict load: every leaf lands on a parameter and no parameter is left
    unset; the values arrive transposed as the table in from_flax says."""
    name, _, params, tcfg = bundle
    model = EMOModel(tcfg, device="cpu", seed=123).load_flax(params)
    subs = _submodels(name)
    for sub in subs:
        own = getattr(model.modules, sub).state_dict()
        assert len(own) == len(list(_leaf_paths(params[sub])))
    if name == "tiny_sd15":  # nn.Embed's table and the position embedding arrive as they are
        clip = params["clip_text"]
        np.testing.assert_array_equal(model.modules.clip_text.token_embedding.weight.numpy(),
                                      np.asarray(clip["token_embedding"]["embedding"]))
        np.testing.assert_array_equal(model.modules.clip_text.position_embedding.detach().numpy(),
                                      np.asarray(clip["position_embedding"]))
        np.testing.assert_array_equal(model.modules.clip_text.layer_0.attn.to_q.weight.numpy(),
                                      np.asarray(clip["layer_0"]["attn"]["to_q"]["kernel"]).T)
    if name == "tiny_side":  # the class token arrives as it is, the 14x14 patch conv HWIO -> OIHW
        vis = params["clip_vision"]
        np.testing.assert_array_equal(model.modules.clip_vision.class_embedding.detach().numpy(),
                                      np.asarray(vis["class_embedding"]))
        np.testing.assert_array_equal(model.modules.clip_vision.patch_embedding.weight.numpy(),
                                      np.asarray(vis["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1))
        assert model.modules.clip_vision.patch_embedding.bias is None
        np.testing.assert_array_equal(model.modules.controlnet.zero_conv_0.weight.numpy(),
                                      np.asarray(params["controlnet"]["zero_conv_0"]["kernel"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(model.modules.denoiser.identity_embed_proj.weight.numpy(),
                                      np.asarray(params["denoiser"]["identity_embed_proj"]["kernel"]).T)
    den = params["denoiser"]
    np.testing.assert_array_equal(model.modules.denoiser.conv_in.weight.numpy(),
                                  np.asarray(den["conv_in"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.modules.denoiser.time_embed.fc1.weight.numpy(),
                                  np.asarray(den["time_embed"]["fc1"]["kernel"]).T)
    audio = params["audio_encoder"]
    np.testing.assert_array_equal(model.modules.audio_encoder.pos_conv.weight.numpy(),
                                  np.asarray(audio["pos_conv"]["kernel"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(model.modules.vae.encoder.norm_out.weight.numpy(),
                                  np.asarray(params["vae"]["encoder"]["norm_out"]["scale"]))


def test_flagship_options_present_in_small_flag():
    """The flagship-flag variant carries the flagship's leaves: 3-axis speed
    buckets, no text cross-attention, temporal and audio layers."""
    _, params, _ = model_params("small_flag")
    den = params["denoiser"]
    assert den["speed_embed"]["fc1"]["kernel"].shape[0] == 3 * 9
    assert "null_context" not in den
    assert any(k.endswith("_temporal") for k in den) and any(k.endswith("_audio") for k in den)
    assert not any("attn2" in ".".join(p) for p in _leaf_paths(den))


def test_unmapped_leaf_raises():
    _, params, tcfg = model_params("tiny")
    model = EMOModel(tcfg, device="cpu")
    bad = dict(params)
    bad["denoiser"] = dict(params["denoiser"], extra_layer={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="no port parameter"):
        load_flax(model.modules, bad)
    with pytest.raises(ValueError, match="no port mapping"):
        from_flax(dict(params, not_a_submodel={}))


def test_unset_parameter_raises():
    _, params, tcfg = model_params("tiny")
    model = EMOModel(tcfg, device="cpu")
    bad = dict(params)
    bad["vae"] = {k: v for k, v in params["vae"].items() if k != "quant_conv"}
    with pytest.raises(ValueError, match="left unset"):
        load_flax(model.modules, bad)
    with pytest.raises(ValueError, match="lacks submodels"):
        load_flax(model.modules, {k: v for k, v in params.items() if k != "audio_encoder"})


def test_skipped_submodels_are_named():
    """No submodel of the reference's tree is skipped any more: the face
    nets map like the rest (3x3 and 1x1 conv kernels HWIO -> OIHW)."""
    _, params, _ = model_params("tiny")
    assert {"face_locator", "landmarker"} <= set(SUBMODELS)
    assert set(from_flax(params)) == set(SUBMODELS) == set(params)
    state = from_flax(params)
    np.testing.assert_array_equal(state["face_locator"]["conv0.weight"].numpy(),
                                  np.asarray(params["face_locator"]["conv0"]["kernel"]).transpose(3, 2, 0, 1))
    assert state["landmarker"]["heat.weight"].shape == (6, 128, 1, 1)
