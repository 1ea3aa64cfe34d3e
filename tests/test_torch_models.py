"""The port's models against the reference's, on the CPU, with the same weights.

The reference's param tree (seeded numpy values at the shapes of
EMOModel.init_params, every leaf nonzero) is carried into the port with
`EMOModel.load_flax`; both then run the same numpy inputs in float32.
Tolerances, relative L2: <= 1e-5 for the VAE, the audio encoder, the
UNet writer and the whole predict_noise (measured: at most 2.3e-6, on the
flagship-flag small variant; float32 sums in another order). The bf16
step, which serving runs, is held to the float32 reference no worse than
1.5x the reference's own bf16 step.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.models import audio as jaudio
from emox.models.unet import reference_net_config as j_reference_net_config
from emox_torch.models import audio as taudio
from emox_torch.models.emo import EMOModel
from emox_torch.models.unet import UNetOutputs, reference_net_config
from tests.test_torch_bridge import FRAMES, IMAGE, model_params, no_kernel_launches, rel_err  # noqa: F401 (autouse fixture)

TOL = 1e-5  # float32, relative L2


@functools.lru_cache(maxsize=None)
def _pair(name: str):
    """(name, reference EMOModel, its params, port EMOModel with those weights)."""
    jm, params, tcfg = model_params(name)
    tm = EMOModel(tcfg, device="cpu", seed=1).load_flax(params)
    return name, jm, params, tm


@pytest.fixture
def pair():
    """The tiny preset: every module-level check."""
    return _pair("tiny")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(cfg, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    lat = IMAGE // cfg.vae.downscale
    axes = cfg.model.speed_axes
    speeds = rng.uniform(-1, 1, (batch, FRAMES) + ((axes,) if axes > 1 else ())).astype(np.float32)
    yy, xx = np.mgrid[:IMAGE, :IMAGE]
    mask = (((yy - IMAGE / 2) ** 2 + (xx - IMAGE / 2) ** 2) < (IMAGE / 3) ** 2).astype(np.float32)
    return dict(
        images=rng.uniform(-1, 1, (batch, IMAGE, IMAGE, 3)).astype(np.float32),
        wav=(0.1 * rng.standard_normal((batch, 16000 * (FRAMES + 4) // 25))).astype(np.float32),
        noisy=rng.standard_normal((batch, FRAMES, lat, lat, cfg.model.in_channels)).astype(np.float32),
        timesteps=np.array([981, 321][:batch], np.int32),
        speeds=speeds,
        mask=np.broadcast_to(mask[None, :, :, None], (batch, IMAGE, IMAGE, 1)).copy(),
    )


def test_reference_net_config_matches(pair):
    _, jm, _, tm = pair
    jc, tc = j_reference_net_config(jm.config.model), reference_net_config(tm.config.model)
    for f in ("use_temporal", "use_audio", "use_speed", "use_face_mask", "block_channels", "attention_levels"):
        assert getattr(jc, f) == getattr(tc, f), f


def test_vae_encode_decode(pair):
    _, jm, params, tm = pair
    x = _inputs(jm.config)
    want = jm.encode_images(params, jnp.asarray(x["images"]))
    got = tm.encode_images(_t(x["images"]))
    assert got.shape == want.shape
    assert rel_err(got, want) <= TOL
    # decode a 5-D clip of latents, also in chunks
    lat = np.random.default_rng(1).standard_normal((1, 3, *want.shape[1:])).astype(np.float32)
    want_img = jm.decode_latents(params, jnp.asarray(lat))
    for chunk in (0, 2):
        got_img = tm.decode_latents(_t(lat), chunk=chunk)
        assert got_img.shape == want_img.shape == (1, 3, IMAGE, IMAGE, 3)
        assert rel_err(got_img, want_img) <= TOL


def test_audio_encoder_and_alignment(pair):
    _, jm, params, tm = pair
    x = _inputs(jm.config)
    feats_want = jm.modules.audio_encoder.apply({"params": params["audio_encoder"]}, jnp.asarray(x["wav"]))
    with torch.no_grad():
        feats_got = tm.modules.audio_encoder(_t(x["wav"]))
    assert rel_err(feats_got, feats_want) <= TOL
    want = jm.encode_audio(params, jnp.asarray(x["wav"]), FRAMES)
    got = tm.encode_audio(_t(x["wav"]), FRAMES)
    assert got.shape == want.shape == (2, FRAMES, 2 * jm.config.audio.context_frames + 1,
                                       jm.config.audio.hidden_dim)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("fps,frames,offset", [(25.0, 6, 0.0), (20.0, 7, 0.0), (20.0, 5, 1.0)])
def test_align_audio_to_frames_rounding(fps, frames, offset):
    """At 20 fps and 50 features/s frame f sits at 2.5 f: half-way positions
    round half to even on both sides, and windows past the clip are zero."""
    feats = np.random.default_rng(2).standard_normal((2, 9, 3)).astype(np.float32)
    want = jaudio.align_audio_to_frames(jnp.asarray(feats), frames, 50.0, fps, 2, offset)
    got = taudio.align_audio_to_frames(_t(feats), frames, 50.0, fps, 2, offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert taudio.audio_feature_rate(jaudio_cfg()) == jaudio.audio_feature_rate(jaudio_cfg())


def jaudio_cfg():
    from emox.core.config import AudioConfig

    return AudioConfig()


def test_unet_writer_banks(pair):
    """ReferenceNet writer: the per-site banks and the output sample."""
    _, jm, params, tm = pair
    x = _inputs(jm.config)
    ref = jm.encode_images(params, jnp.asarray(x["images"]))
    ts = jnp.asarray(x["timesteps"])
    want = jm.reference_outputs(params, ref, ts)
    got = tm.reference_outputs(_t(ref), _t(x["timesteps"]).long())
    assert isinstance(got, UNetOutputs)
    assert rel_err(got.sample, want.sample) <= TOL
    assert len(got.ref_features) == len(want.ref_features) > 0
    for g_site, w_site in zip(got.ref_features, want.ref_features):
        for g, w in zip(g_site, w_site):
            assert g.shape == w.shape
            assert rel_err(g, w) <= TOL


def test_reference_outputs_for_steps(pair):
    """One batched writer pass for S timesteps equals S separate passes."""
    _, jm, params, tm = pair
    x = _inputs(jm.config, batch=1)
    ref = jm.encode_images(params, jnp.asarray(x["images"]))
    steps = np.array([900, 500, 100], np.int32)
    want, _ = jm.reference_outputs_for_steps(params, ref, jnp.asarray(steps))
    got, gn = tm.reference_outputs_for_steps(_t(ref), _t(steps).long())
    assert gn is None
    for g_site, w_site in zip(got, want):
        for g, w in zip(g_site, w_site):
            assert g.shape == w.shape and g.shape[0] == 3
            assert rel_err(g, w) <= TOL


@pytest.mark.parametrize("name", ["tiny", "small_flag"])
def test_predict_noise_all_conditioning(name):
    """The reader with reference banks (CFG drop on one row), audio windows,
    per-frame speeds (3 axes in small_flag) and the pre-encoded face mask,
    each conditioning input first held against the reference on its own."""
    _, jm, params, tm = _pair(name)
    x = _inputs(jm.config, seed=3)
    ref = jm.encode_images(params, jnp.asarray(x["images"]))
    assert rel_err(tm.encode_images(_t(x["images"])), ref) <= TOL
    audio = jm.encode_audio(params, jnp.asarray(x["wav"]), FRAMES)
    assert rel_err(tm.encode_audio(_t(x["wav"]), FRAMES), audio) <= TOL
    lat = IMAGE // jm.config.vae.downscale
    face_w = jm.encode_face_mask(params, jnp.asarray(x["mask"]), lat)
    face_g = tm.encode_face_mask(_t(x["mask"]), lat)
    assert rel_err(face_g, face_w) <= TOL
    drop = np.array([True, False])
    want = jm.predict_noise(params, jnp.asarray(x["noisy"]), jnp.asarray(x["timesteps"]), ref,
                            audio_windows=audio, speeds=jnp.asarray(x["speeds"]), face_feat=face_w,
                            ref_dropout=jnp.asarray(drop))
    got = tm.predict_noise(_t(x["noisy"]), _t(x["timesteps"]).long(), _t(ref), audio_windows=_t(audio),
                           speeds=_t(x["speeds"]), face_feat=face_g, ref_dropout=_t(drop))
    assert got.shape == want.shape == x["noisy"].shape
    err = rel_err(got, want)
    assert err <= TOL, (name, err)
    # every branch moves the output: the conditioning is not silently dropped
    plain = tm.predict_noise(_t(x["noisy"]), _t(x["timesteps"]).long(), None)
    assert rel_err(plain, want) > 100 * TOL


def test_predict_noise_with_precomputed_banks(pair):
    """ref_features= from the writer gives what ref_latent= gives."""
    _, jm, params, tm = pair
    x = _inputs(jm.config, seed=4)
    ref = tm.encode_images(_t(x["images"]))
    ts = _t(x["timesteps"]).long()
    direct = tm.predict_noise(_t(x["noisy"]), ts, ref)
    banks = tm.reference_outputs(ref, ts).ref_features
    via_banks = tm.predict_noise(_t(x["noisy"]), ts, None, ref_features=banks)
    torch.testing.assert_close(via_banks, direct, rtol=0, atol=0)


def test_predict_noise_bf16_stays_within_the_references_bf16_error():
    """Serving runs in bf16. The port's bf16 step is held to the float32
    reference no worse than 1.5x the reference's own bf16 step is: a
    misplaced rounding point would show as a larger error, while bf16
    noise alone (about 2e-2 relative here) is the same on both sides."""
    import jax

    from emox.models.emo import EMOModel as JEMOModel

    _, jm32, params, _ = _pair("tiny")
    jm16 = JEMOModel(jm32.config, dtype=jnp.bfloat16)
    p16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tcfg = model_params("tiny")[2]
    tm16 = EMOModel(tcfg, dtype=torch.bfloat16, device="cpu").load_flax(params)
    x = _inputs(jm32.config, seed=5)
    ref = jm32.encode_images(params, jnp.asarray(x["images"]))
    audio = jm32.encode_audio(params, jnp.asarray(x["wav"]), FRAMES)
    drop = np.array([True, False])
    kw = dict(audio_windows=audio, speeds=jnp.asarray(x["speeds"]), ref_dropout=jnp.asarray(drop))
    truth = jm32.predict_noise(params, jnp.asarray(x["noisy"]), jnp.asarray(x["timesteps"]), ref, **kw)
    ref_bf16 = jm16.predict_noise(p16, jnp.asarray(x["noisy"]), jnp.asarray(x["timesteps"]), ref, **kw)
    got = tm16.predict_noise(_t(x["noisy"]), _t(x["timesteps"]).long(), _t(ref), audio_windows=_t(audio),
                             speeds=_t(x["speeds"]), ref_dropout=_t(drop))
    assert got.dtype == torch.bfloat16
    budget = rel_err(np.asarray(ref_bf16, np.float32), truth)
    assert 0 < rel_err(got.float(), truth) <= 1.5 * budget
