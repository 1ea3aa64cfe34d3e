"""The port's configuration is the reference's, field for field.

emox_torch keeps its own copy of the dataclasses (it imports nothing of
emox), so these tests hold the copy to the original: the same classes,
the same fields in the same order with the same defaults, the same three
presets, and YAML that either side writes loads on the other.
"""

from __future__ import annotations

import dataclasses

import pytest

from emox.core import config as jconfig
from emox.core import presets as jpresets
from emox.data.augment import AugmentConfig as JAugmentConfig
from emox_torch.core import config as tconfig
from emox_torch.core import presets as tpresets


def _dataclasses(module):
    return {name: obj for name, obj in vars(module).items()
            if dataclasses.is_dataclass(obj) and isinstance(obj, type) and obj.__module__ == module.__name__}


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        else:
            default = dataclasses.MISSING
        out.append((f.name, default if not dataclasses.is_dataclass(default) else dataclasses.asdict(default)))
    return out


def test_same_dataclasses():
    ref = _dataclasses(jconfig)
    port = {n: c for n, c in _dataclasses(tconfig).items() if n != "AugmentConfig"}
    assert set(port) == set(ref)
    for name in ref:
        assert _fields(port[name]) == _fields(ref[name]), name
        assert port[name].__dataclass_params__.frozen == ref[name].__dataclass_params__.frozen, name


def test_augment_config_copy():
    assert _fields(tconfig.AugmentConfig) == _fields(JAugmentConfig)


@pytest.mark.parametrize("name", ["flagship", "small", "tiny"])
def test_derived_properties(name):
    ref, port = jpresets.PRESETS[name](), tpresets.PRESETS[name]()
    assert port.model.block_channels == ref.model.block_channels
    assert port.vae.downscale == ref.vae.downscale
    assert port.audio.total_stride == ref.audio.total_stride
    assert port.audio.frames_per_window == ref.audio.frames_per_window


@pytest.mark.parametrize("name", ["flagship", "small", "tiny"])
def test_presets(name):
    assert set(tpresets.PRESETS) == set(jpresets.PRESETS)
    for size, frames in ((None, None), (64, 4)):
        kw = {} if size is None else dict(image_size=size, num_frames=frames)
        ref = jpresets.PRESETS[name](**kw)
        port = tpresets.PRESETS[name](**kw)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_flagship_is_the_served_configuration():
    """What the port serves: no text cross-attention, 3-axis speeds, every
    option it has not ported off."""
    m = tpresets.flagship_config().model
    assert (m.base_channels, m.channel_multipliers, m.attention_levels) == (320, (1, 2, 4, 4), (0, 1, 2))
    assert not m.use_cross_attention and m.speed_axes == 3
    assert not (m.use_gn_ref or m.use_sparse_causal or m.use_controlnet or m.use_identity_embed)


def test_yaml_round_trip_both_ways(tmp_path):
    cfg = tpresets.small_config(64, 4).replace(
        diffusion=dataclasses.replace(tconfig.DiffusionConfig(), ddim_eta=0.3)
    )
    tconfig.save_config(cfg, str(tmp_path / "port.yaml"))
    assert dataclasses.asdict(jconfig.load_config(str(tmp_path / "port.yaml"))) == dataclasses.asdict(cfg)
    assert tconfig.load_config(str(tmp_path / "port.yaml")) == cfg
    jconfig.save_config(jpresets.flagship_config(), str(tmp_path / "ref.yaml"))
    port = tconfig.load_config(str(tmp_path / "ref.yaml"), overrides={"inference": {"guidance_scale": 3.0}})
    want = dataclasses.asdict(jpresets.flagship_config())
    want["inference"]["guidance_scale"] = 3.0
    assert dataclasses.asdict(port) == want


def test_load_config_rejects_unknown():
    with pytest.raises(ValueError, match="unknown config sections"):
        tconfig.load_config(overrides={"nope": {}})
    with pytest.raises(ValueError, match="unknown ModelConfig fields"):
        tconfig.load_config(overrides={"model": {"nope": 1}})
