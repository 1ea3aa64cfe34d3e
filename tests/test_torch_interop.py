"""The port's weight import from diffusers / transformers checkpoints
(emox_torch.interop.torch_import) against the reference's
(emox/interop/torch_import.py).

For each of the five import functions the same synthetic state dict (the
diffusers / transformers names, from tests/torch_ref.py's TMiniVAE and
TMiniUNet and transformers' models at tiny widths) goes through the
reference's import and from_flax's transforms, and through the port's: the
tensors agree bit for bit and the reports agree in the port's names. The
imported port modules hold the forward parity the reference's own interop
tests hold (tests/test_interop.py: 2e-4 for the VAE, wav2vec2 and CLIP,
5e-4 for the UNet). The .safetensors reader needs no package: it reads F32,
F16 and BF16 files written here byte by byte and gives the .pt path's
tensors.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np
import pytest
import torch

from emox.core import config as jconfig
from emox.interop import torch_import as jimport
from emox_torch.core import config as tconfig
from emox_torch.interop import torch_import as timport
from emox_torch.interop.from_flax import state_dict_from_flax
from emox_torch.models.audio import AudioEncoder
from emox_torch.models.clip import CLIPTextEncoder, CLIPVisionEncoder
from emox_torch.models.unet import UNet
from emox_torch.models.vae import AutoencoderKL
from emox_torch.nn.layers import init_weights

from tests.test_torch_bridge import no_kernel_launches, rel_err  # noqa: F401
from tests.torch_ref import TMiniUNet, TMiniVAE

VAE = dict(base_channels=16, channel_multipliers=(1, 2), num_res_blocks=1, norm_groups=4)
UNET2D = dict(base_channels=16, channel_multipliers=(1, 2), layers_per_block=1, norm_groups=4, attention_heads=2,
              resnet_temb_mode="add", cross_attention_dim=16, attention_levels=(0, 1), use_temporal=False,
              use_audio=False, use_speed=False, use_face_mask=False, use_reference=False)
AUDIO = dict(hidden_dim=32, num_layers=2, num_heads=2, conv_dim=16)
CLIP_TEXT = dict(text_enabled=True, vocab_size=99, text_hidden_dim=32, text_layers=2, text_heads=2, max_positions=16,
                 hidden_act="quick_gelu")
CLIP_VISION = dict(vision_enabled=True, vision_hidden_dim=32, vision_layers=2, vision_heads=2, image_size=16,
                   patch_size=8, projection_dim=24, hidden_act="quick_gelu")


def _sd(model) -> dict:
    torch.manual_seed(0)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _np(sd) -> dict:
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy() for k, v in sd.items()}


def _tiny_vae():
    torch.manual_seed(0)
    return TMiniVAE(chans=(16, 32), num_res=1, groups=4).eval()


def _tiny_unet():
    torch.manual_seed(1)
    return TMiniUNet(chans=(16, 32), layers=1, groups=4, heads=2, cross_dim=16).eval()


def _wav2vec2():
    from transformers import Wav2Vec2Config, Wav2Vec2Model

    torch.manual_seed(2)
    return Wav2Vec2Model(Wav2Vec2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
        conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2),
        feat_extract_norm="group", do_stable_layer_norm=False, num_conv_pos_embeddings=128,
        num_conv_pos_embedding_groups=16, hidden_act="gelu", feat_extract_activation="gelu", layer_norm_eps=1e-5,
    )).eval()


def _clip_text():
    from transformers import CLIPTextConfig, CLIPTextModel

    torch.manual_seed(3)
    return CLIPTextModel(CLIPTextConfig(vocab_size=99, hidden_size=32, intermediate_size=128, num_hidden_layers=2,
                                        num_attention_heads=2, max_position_embeddings=16,
                                        hidden_act="quick_gelu")).eval()


def _clip_vision():
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    torch.manual_seed(4)
    return CLIPVisionModelWithProjection(CLIPVisionConfig(
        hidden_size=32, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2, image_size=16,
        patch_size=8, projection_dim=24, hidden_act="quick_gelu")).eval()


# name -> (source model, import function name, config of the package given)
COMPONENTS = {
    "vae": (_tiny_vae, "import_vae", lambda m: m.VAEConfig(**VAE)),
    "unet": (_tiny_unet, "import_unet2d", lambda m: m.ModelConfig(**UNET2D)),
    "wav2vec2": (_wav2vec2, "import_wav2vec2", lambda m: m.AudioConfig(**AUDIO)),
    "clip_text": (_clip_text, "import_clip_text", lambda m: m.CLIPConfig(**CLIP_TEXT)),
    "clip_vision": (_clip_vision, "import_clip_vision", lambda m: m.CLIPConfig(**CLIP_VISION)),
}


def _old_namings(name: str, sd: dict) -> dict:
    """The same weights under the older spellings the imports accept: the
    VAE's query/key/value/proj_attn, SD < 0.11's 1x1-conv proj_in/out,
    wav2vec2's weight_g/weight_v."""
    out = {}
    for k, v in sd.items():
        if name == "vae":
            k = (k.replace(".to_q.", ".query.").replace(".to_k.", ".key.").replace(".to_v.", ".value.")
                 .replace(".to_out.0.", ".proj_attn."))
        elif name == "unet" and (".proj_in.weight" in k or ".proj_out.weight" in k):
            v = v[:, :, None, None]
        elif name == "wav2vec2":
            k = k.replace("parametrizations.weight.original0", "weight_g").replace(
                "parametrizations.weight.original1", "weight_v")
        out[k] = v
    return out


@pytest.mark.parametrize("name,naming", [(n, "current") for n in COMPONENTS] +
                         [(n, "older") for n in ("vae", "unet", "wav2vec2")])
def test_import_gives_the_references_tensors_bit_for_bit(name, naming):
    make, fn, cfg = COMPONENTS[name]
    sd = _sd(make())
    if naming == "older":
        sd = _old_namings(name, sd)
    want_tree = getattr(jimport, fn)(_np(sd), cfg(jconfig))
    want_report = want_tree.pop("__report__")
    want = state_dict_from_flax(want_tree)
    got = getattr(timport, fn)(sd, cfg(tconfig))
    report = got.pop("__report__")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    assert report.loaded == [timport.port_key(p) for p in want_report.loaded]
    assert report.missing_in_source == [timport.port_key(p) for p in want_report.missing_in_source]
    assert report.unused_source_keys == want_report.unused_source_keys
    # wav2vec2's SpecAugment mask embedding serves pretraining only
    assert not report.missing_in_source and report.unused_source_keys in ([], ["masked_spec_embed"])
    assert report.summary() == want_report.summary()


def _merged(module: torch.nn.Module, imported: dict) -> torch.nn.Module:
    init_weights(module, torch.Generator().manual_seed(9))
    return timport.merge_imported(module, imported).eval()


def test_imported_vae_matches_the_torch_reference():
    tm = _tiny_vae()
    vae = _merged(AutoencoderKL(tconfig.VAEConfig(**VAE)), timport.import_vae(_sd(tm), tconfig.VAEConfig(**VAE)))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 16, 16, 3)).astype(np.float32))
    z = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 8, 8, 4)).astype(np.float32))
    with torch.no_grad():
        want = tm.encode_moments(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        dist = vae.encode(x)
        assert rel_err(torch.cat([dist.mean, dist.logvar], -1), want.numpy()) <= 2e-4
        want = tm.decode(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert rel_err(vae.decode(z), want.numpy()) <= 2e-4


def test_imported_unet_matches_the_torch_reference():
    tm = _tiny_unet()
    cfg = tconfig.ModelConfig(**UNET2D)
    net = _merged(UNet(cfg), timport.import_unet2d(_sd(tm), cfg))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.normal(size=(2, 3, 16)).astype(np.float32))
    t = torch.tensor([7, 400])
    with torch.no_grad():
        want = tm(x.permute(0, 3, 1, 2), t, ctx).permute(0, 2, 3, 1)
        assert rel_err(net(x, t, context=ctx).sample, want.numpy()) <= 5e-4


def test_imported_audio_and_clip_encoders_match_transformers():
    hf = _wav2vec2()
    enc = _merged(AudioEncoder(tconfig.AudioConfig(**AUDIO)),
                  timport.import_wav2vec2(_sd(hf), tconfig.AudioConfig(**AUDIO)))
    wav = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 8000)).astype(np.float32))
    with torch.no_grad():
        assert rel_err(enc(wav), hf(wav).last_hidden_state.numpy()) <= 2e-4
    cfg = tconfig.CLIPConfig(**CLIP_TEXT)
    hf = _clip_text()
    text = _merged(CLIPTextEncoder(cfg), timport.import_clip_text(_sd(hf), cfg))
    ids = torch.tensor([[49, 3, 7, 11, 2, 98, 0, 0]])
    with torch.no_grad():
        assert rel_err(text(ids), hf(ids).last_hidden_state.numpy()) <= 2e-4
    cfg = tconfig.CLIPConfig(**CLIP_VISION)
    hf = _clip_vision()
    vision = _merged(CLIPVisionEncoder(cfg), timport.import_clip_vision(_sd(hf), cfg))
    img = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        assert rel_err(vision(img), hf(img.permute(0, 3, 1, 2)).image_embeds.numpy()) <= 2e-4


def test_merge_keeps_video_only_parameters_and_refuses_a_wrong_shape():
    tm = _tiny_unet()
    cfg = tconfig.ModelConfig(**{**UNET2D, "use_temporal": True, "use_audio": True, "use_speed": True,
                                 "use_face_mask": True, "use_reference": True})
    imported = timport.import_unet2d(_sd(tm), cfg)
    report = imported["__report__"]
    assert not report.missing_in_source and not report.unused_source_keys
    net = UNet(cfg, face_mask_downs=1)
    init_weights(net, torch.Generator().manual_seed(9))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    timport.merge_imported(net, imported)
    after = net.state_dict()
    video_only = ("_temporal", "_audio", "speed_embed", "face_mask_encoder", "null_context")
    kept = [k for k in after if k not in imported]
    assert kept and all(any(v in k for v in video_only) for k in kept), kept
    assert all(torch.equal(after[k], before[k]) for k in kept)
    assert all(torch.equal(after[k], imported[k]) for k in imported if k != "__report__")
    assert torch.equal(after["down_0_0_temporal.proj_out.weight"], torch.zeros_like(before[
        "down_0_0_temporal.proj_out.weight"]))
    # a state dict target: a new dict in the target's dtype
    half = {k: v.half() for k, v in before.items()}
    merged = timport.merge_imported(half, imported)
    assert merged["conv_in.weight"].dtype == torch.float16 and half["conv_in.weight"].dtype == torch.float16
    assert torch.equal(merged["conv_in.weight"], imported["conv_in.weight"].half())
    wrong = dict(imported, **{"conv_in.weight": imported["conv_in.weight"][:, :2]})
    with pytest.raises(ValueError, match="shape mismatch at conv_in.weight"):
        timport.merge_imported(net, wrong)
    with pytest.raises(KeyError, match="not_a_param"):
        timport.merge_imported(net, {"not_a_param": torch.zeros(1)})


def _write_safetensors(path, tensors: dict, dtypes: dict) -> None:
    """A .safetensors file byte by byte: header length (u64 LE), JSON
    header, the tensors' little-endian bytes."""
    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for name, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": dtypes[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_round_trips_without_the_package(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(3, 5, generator=g).to(dtype), "b": torch.randn(7, generator=g).to(dtype),
               "empty": torch.zeros(0, 4, dtype=dtype), "c.bias": torch.randn(2, 1, 3, generator=g).to(dtype)}
    path = tmp_path / "w.safetensors"
    _write_safetensors(path, tensors, {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"})
    got = timport.load_torch_state_dict(str(path))
    torch.save(tensors, tmp_path / "w.pt")
    via_pt = timport.load_torch_state_dict(str(tmp_path / "w.pt"))
    assert set(got) == set(via_pt) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == via_pt[k].dtype == dtype and got[k].shape == t.shape
        assert torch.equal(got[k], t) and torch.equal(via_pt[k], t)
    torch.save({"state_dict": tensors}, tmp_path / "wrapped.pth")
    assert set(timport.load_torch_state_dict(str(tmp_path / "wrapped.pth"))) == set(tensors)


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    path = tmp_path / "i.safetensors"
    _write_safetensors(path, {"i": torch.arange(4, dtype=torch.int64)}, {torch.int64: "I64"})
    with pytest.raises(ValueError, match="I64"):
        timport.read_safetensors(str(path))


def test_sd15_layout_imports_key_for_key():
    """SD-1.5's UNet layout (320/640/1280/1280, 2 layers, 8 heads, cross 768,
    attention at levels 0-2) into the port's denoiser of that layout, on the
    meta device: every source tensor used, every shape the port's, and every
    parameter left at init video-only."""
    with torch.device("meta"):
        tm = TMiniUNet(chans=(320, 640, 1280, 1280), layers=2, groups=32, heads=8, cross_dim=768,
                       attn_levels=(0, 1, 2))
        cfg = dataclasses.replace(tconfig.ModelConfig(), base_channels=320, channel_multipliers=(1, 2, 4, 4),
                                  layers_per_block=2, norm_groups=32, attention_heads=8, resnet_temb_mode="add",
                                  cross_attention_dim=768, attention_levels=(0, 1, 2))
        net = UNet(cfg)
    sd = {k: torch.zeros(v.shape) for k, v in tm.state_dict().items()}
    assert len(sd) > 600
    imported = timport.import_unet2d(sd, cfg)
    report = imported.pop("__report__")
    assert not report.unused_source_keys
    video_only = ("_temporal", "_audio", "speed_embed", "face_mask_encoder", "null_context")
    assert all(any(v in k for v in video_only) for k in report.missing_in_source)
    own = net.state_dict()
    assert all(tuple(own[k].shape) == tuple(v.shape) for k, v in imported.items())
    kept = set(own) - set(imported)
    assert kept and all(any(v in k for v in video_only) for k in kept)
