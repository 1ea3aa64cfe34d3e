"""Weights from diffusers / transformers checkpoints (counterpart of
emox/interop/torch_import.py).

Maps the state dicts of diffusers' AutoencoderKL and UNet2DConditionModel
and transformers' Wav2Vec2Model, CLIPTextModel and
CLIPVisionModelWithProjection onto the port's state-dict names: the
reference's flax path with "/" as "." and its leaf `kernel`, `scale` or
`embedding` as `weight` (emox_torch/interop/from_flax.py). The port's
modules hold torch layouts, so a leaf goes in as the checkpoint holds it,
with three exceptions:
  * the 1x1-conv proj_in / proj_out of diffusers before 0.11 become the
    port's Dense weight [O, I];
  * wav2vec2's weight-normed positional conv is folded, w = g * v / |v|
    (norm over dims 0 and 1), from either naming (weight_g / weight_v, or
    torch >= 2.1's parametrizations);
  * `position_ids` buffers are dropped.
Every leaf is float32 (numpy), as the reference reads it, so an import
gives the reference's tensors bit for bit once from_flax has mapped its
tree. Temporal, audio, speed, face and `null_context` parameters have no
source and keep their init: merge_imported overlays what was imported
(the reference's strict=False inflation, unet_controlnet.py:516-523).

Faithful import of SD-1.5 needs ModelConfig(attention_heads=8,
resnet_temb_mode="add"). Checkpoints are read with torch.load
(weights_only) or, for .safetensors, by read_safetensors below, which needs
no package.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn

StateDict = Dict[str, Any]  # name -> torch tensor or numpy array
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file's tensors: an 8-byte little-endian header
    length, a JSON header (name -> dtype, shape, data_offsets; and
    __metadata__), then the tensors' bytes. F32, F16 and BF16 (the last
    through torch: numpy has no bf16)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; the reader takes {sorted(_ST_DTYPES)}")
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        size = torch.empty((), dtype=dtype).element_size()
        count = (end - start) // size
        if count != int(np.prod(info["shape"], dtype=np.int64)):
            raise ValueError(f"{path}: {name} holds {end - start} bytes for shape {info['shape']}")
        if count == 0:
            t = torch.empty(info["shape"], dtype=dtype)
        elif start % size:  # unaligned: a copy of its bytes
            t = torch.frombuffer(bytearray(data[start:end]), dtype=dtype)
        else:
            t = torch.frombuffer(data, dtype=dtype, count=count, offset=start)
        out[name] = t.reshape(info["shape"])
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint's tensors: .safetensors through read_safetensors, else
    (.pt, .pth, .bin) torch.load with weights_only, a `state_dict` entry
    unwrapped."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


def port_key(path: str) -> str:
    """The port's state-dict name of a flax path (from_flax's table)."""
    *mods, leaf = path.split("/")
    return ".".join([*mods, "weight" if leaf in ("kernel", "scale", "embedding") else leaf])


def _conv1x1_dense(w: np.ndarray) -> np.ndarray:
    """A 1x1 conv OI11 as a Dense weight [O, I] (SD < 0.11's proj_in/out)."""
    return w[:, :, 0, 0] if w.ndim == 4 else w


@dataclass
class InflationReport:
    """What loaded and what stayed at init, in the port's names."""

    loaded: List[str] = field(default_factory=list)
    missing_in_source: List[str] = field(default_factory=list)
    unused_source_keys: List[str] = field(default_factory=list)

    def summary(self) -> str:
        return (
            f"loaded {len(self.loaded)} tensors; "
            f"{len(self.missing_in_source)} target params kept at init "
            f"(temporal/audio/speed/face); {len(self.unused_source_keys)} source keys unused"
        )


class _Mapper:
    def __init__(self, sd: StateDict):
        self.sd = sd
        self.out: Dict[str, Any] = {}
        self.report = InflationReport()
        self.used: set = set()

    def take(self, key: str) -> Optional[np.ndarray]:
        if key not in self.sd:
            return None
        self.used.add(key)
        v = self.sd[key]
        return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v).astype(np.float32)

    def put(self, path: str, key: str, transform: Callable = None) -> None:
        v = self.take(key)
        name = port_key(path)
        if v is None:
            self.report.missing_in_source.append(name)
            return
        self.out[name] = torch.from_numpy(np.array(transform(v) if transform else v, copy=True, order="C"))
        self.report.loaded.append(name)

    def finish(self) -> Dict[str, Any]:
        self.report.unused_source_keys = sorted(set(self.sd) - self.used)
        return {**self.out, "__report__": self.report}


def _map_resblock(m: _Mapper, dst: str, src: str, has_temb: bool) -> None:
    m.put(f"{dst}/norm1/scale", f"{src}.norm1.weight")
    m.put(f"{dst}/norm1/bias", f"{src}.norm1.bias")
    m.put(f"{dst}/conv1/kernel", f"{src}.conv1.weight")
    m.put(f"{dst}/conv1/bias", f"{src}.conv1.bias")
    if has_temb:
        m.put(f"{dst}/time_proj/kernel", f"{src}.time_emb_proj.weight")
        m.put(f"{dst}/time_proj/bias", f"{src}.time_emb_proj.bias")
    m.put(f"{dst}/norm2/scale", f"{src}.norm2.weight")
    m.put(f"{dst}/norm2/bias", f"{src}.norm2.bias")
    m.put(f"{dst}/conv2/kernel", f"{src}.conv2.weight")
    m.put(f"{dst}/conv2/bias", f"{src}.conv2.bias")
    if f"{src}.conv_shortcut.weight" in m.sd:
        m.put(f"{dst}/skip/kernel", f"{src}.conv_shortcut.weight")
        m.put(f"{dst}/skip/bias", f"{src}.conv_shortcut.bias")


def _map_vae_attn(m: _Mapper, dst: str, src: str) -> None:
    # newer diffusers: to_q/to_k/to_v/to_out.0; older: query/key/value/proj_attn
    newer = f"{src}.to_q.weight" in m.sd
    q, k, v, o = ("to_q", "to_k", "to_v", "to_out.0") if newer else ("query", "key", "value", "proj_attn")
    m.put(f"{dst}/norm/scale", f"{src}.group_norm.weight")
    m.put(f"{dst}/norm/bias", f"{src}.group_norm.bias")
    for name, s in (("to_q", q), ("to_k", k), ("to_v", v), ("to_out", o)):
        m.put(f"{dst}/attn/{name}/kernel", f"{src}.{s}.weight")
        m.put(f"{dst}/attn/{name}/bias", f"{src}.{s}.bias")


def import_vae(sd: StateDict, cfg) -> Dict[str, Any]:
    """diffusers AutoencoderKL state dict -> the port's AutoencoderKL state
    dict (and "__report__": its InflationReport)."""
    m = _Mapper(sd)
    n_levels = len(cfg.channel_multipliers)
    for side in ("encoder", "decoder"):
        m.put(f"{side}/conv_in/kernel", f"{side}.conv_in.weight")
        m.put(f"{side}/conv_in/bias", f"{side}.conv_in.bias")
        for i in range(2):
            _map_resblock(m, f"{side}/mid_res_{i}", f"{side}.mid_block.resnets.{i}", False)
        _map_vae_attn(m, f"{side}/mid_attn", f"{side}.mid_block.attentions.0")
        m.put(f"{side}/norm_out/scale", f"{side}.conv_norm_out.weight")
        m.put(f"{side}/norm_out/bias", f"{side}.conv_norm_out.bias")
        m.put(f"{side}/conv_out/kernel", f"{side}.conv_out.weight")
        m.put(f"{side}/conv_out/bias", f"{side}.conv_out.bias")
    for lvl in range(n_levels):
        for i in range(cfg.num_res_blocks):
            _map_resblock(m, f"encoder/down_{lvl}_res_{i}", f"encoder.down_blocks.{lvl}.resnets.{i}", False)
        if lvl < n_levels - 1:
            m.put(f"encoder/down_{lvl}_ds/Conv_0/kernel", f"encoder.down_blocks.{lvl}.downsamplers.0.conv.weight")
            m.put(f"encoder/down_{lvl}_ds/Conv_0/bias", f"encoder.down_blocks.{lvl}.downsamplers.0.conv.bias")
    # decoder up_blocks.{k}: k = 0 is the deepest, the port's up_{n_levels-1-k}
    for k in range(n_levels):
        lvl = n_levels - 1 - k
        for i in range(cfg.num_res_blocks + 1):
            _map_resblock(m, f"decoder/up_{lvl}_res_{i}", f"decoder.up_blocks.{k}.resnets.{i}", False)
        if lvl > 0:
            m.put(f"decoder/up_{lvl}_us/Conv_0/kernel", f"decoder.up_blocks.{k}.upsamplers.0.conv.weight")
            m.put(f"decoder/up_{lvl}_us/Conv_0/bias", f"decoder.up_blocks.{k}.upsamplers.0.conv.bias")
    for conv in ("quant_conv", "post_quant_conv"):
        m.put(f"{conv}/kernel", f"{conv}.weight")
        m.put(f"{conv}/bias", f"{conv}.bias")
    return m.finish()


def _map_transformer_block(m: _Mapper, dst: str, src: str) -> None:
    for norm in ("norm1", "norm2", "norm3"):
        m.put(f"{dst}/{norm}/scale", f"{src}.{norm}.weight")
        m.put(f"{dst}/{norm}/bias", f"{src}.{norm}.bias")
    for attn in ("attn1", "attn2"):
        for proj in ("to_q", "to_k", "to_v"):
            m.put(f"{dst}/{attn}/{proj}/kernel", f"{src}.{attn}.{proj}.weight")
        m.put(f"{dst}/{attn}/to_out/kernel", f"{src}.{attn}.to_out.0.weight")
        m.put(f"{dst}/{attn}/to_out/bias", f"{src}.{attn}.to_out.0.bias")
    m.put(f"{dst}/ff/proj_in/kernel", f"{src}.ff.net.0.proj.weight")
    m.put(f"{dst}/ff/proj_in/bias", f"{src}.ff.net.0.proj.bias")
    m.put(f"{dst}/ff/proj_out/kernel", f"{src}.ff.net.2.weight")
    m.put(f"{dst}/ff/proj_out/bias", f"{src}.ff.net.2.bias")


def _map_spatial_transformer(m: _Mapper, dst: str, src: str, depth: int = 1) -> None:
    m.put(f"{dst}/norm/scale", f"{src}.norm.weight")
    m.put(f"{dst}/norm/bias", f"{src}.norm.bias")
    m.put(f"{dst}/proj_in/kernel", f"{src}.proj_in.weight", _conv1x1_dense)
    m.put(f"{dst}/proj_in/bias", f"{src}.proj_in.bias")
    for d in range(depth):
        _map_transformer_block(m, f"{dst}/block_{d}", f"{src}.transformer_blocks.{d}")
    m.put(f"{dst}/proj_out/kernel", f"{src}.proj_out.weight", _conv1x1_dense)
    m.put(f"{dst}/proj_out/bias", f"{src}.proj_out.bias")


def import_unet2d(sd: StateDict, cfg) -> Dict[str, Any]:
    """diffusers UNet2DConditionModel state dict -> the port's UNet state
    dict (and "__report__"), for the ReferenceNet (2-D config) and the
    denoiser alike: the denoiser's temporal, audio, speed and face
    parameters are reported missing and keep their init."""
    m = _Mapper(sd)
    n_levels = len(cfg.channel_multipliers)
    m.put("conv_in/kernel", "conv_in.weight")
    m.put("conv_in/bias", "conv_in.bias")
    for fc, src in (("fc1", "linear_1"), ("fc2", "linear_2")):
        m.put(f"time_embed/{fc}/kernel", f"time_embedding.{src}.weight")
        m.put(f"time_embed/{fc}/bias", f"time_embedding.{src}.bias")
    for lvl in range(n_levels):
        for i in range(cfg.layers_per_block):
            _map_resblock(m, f"down_{lvl}_res_{i}", f"down_blocks.{lvl}.resnets.{i}", True)
            if lvl in cfg.attention_levels:
                _map_spatial_transformer(m, f"down_{lvl}_{i}_attn", f"down_blocks.{lvl}.attentions.{i}")
        if lvl < n_levels - 1:
            m.put(f"down_{lvl}_ds/Conv_0/kernel", f"down_blocks.{lvl}.downsamplers.0.conv.weight")
            m.put(f"down_{lvl}_ds/Conv_0/bias", f"down_blocks.{lvl}.downsamplers.0.conv.bias")
    _map_resblock(m, "mid_res_0", "mid_block.resnets.0", True)
    _map_spatial_transformer(m, "mid_attn", "mid_block.attentions.0")
    _map_resblock(m, "mid_res_1", "mid_block.resnets.1", True)
    # up_blocks.{k}: k = 0 is the deepest, the port's up_{n_levels-1-k}
    for k in range(n_levels):
        lvl = n_levels - 1 - k
        for i in range(cfg.layers_per_block + 1):
            _map_resblock(m, f"up_{lvl}_res_{i}", f"up_blocks.{k}.resnets.{i}", True)
            if lvl in cfg.attention_levels:
                _map_spatial_transformer(m, f"up_{lvl}_{i}_attn", f"up_blocks.{k}.attentions.{i}")
        if lvl > 0:
            m.put(f"up_{lvl}_us/Conv_0/kernel", f"up_blocks.{k}.upsamplers.0.conv.weight")
            m.put(f"up_{lvl}_us/Conv_0/bias", f"up_blocks.{k}.upsamplers.0.conv.bias")
    m.put("norm_out/scale", "conv_norm_out.weight")
    m.put("norm_out/bias", "conv_norm_out.bias")
    m.put("conv_out/kernel", "conv_out.weight")
    m.put("conv_out/bias", "conv_out.bias")
    return m.finish()


def import_wav2vec2(sd: StateDict, cfg) -> Dict[str, Any]:
    """transformers Wav2Vec2Model state dict -> the port's AudioEncoder
    state dict (and "__report__")."""
    m = _Mapper(sd)
    pre = "wav2vec2." if any(k.startswith("wav2vec2.") for k in sd) else ""
    fe = f"{pre}feature_extractor.conv_layers"
    for i in range(len(cfg.conv_kernels)):
        m.put(f"feature_extractor/conv{i}/kernel", f"{fe}.{i}.conv.weight")
        if i == 0:
            m.put("feature_extractor/gn0/scale", f"{fe}.0.layer_norm.weight")
            m.put("feature_extractor/gn0/bias", f"{fe}.0.layer_norm.bias")
    m.put("feat_norm/scale", f"{pre}feature_projection.layer_norm.weight")
    m.put("feat_norm/bias", f"{pre}feature_projection.layer_norm.bias")
    m.put("feat_proj/kernel", f"{pre}feature_projection.projection.weight")
    m.put("feat_proj/bias", f"{pre}feature_projection.projection.bias")
    # the weight-normed positional conv (torch weight_norm dim=2 on [O, I/g, K]:
    # a norm per K slice over dims 0 and 1): w = g * v / |v|
    conv = f"{pre}encoder.pos_conv_embed.conv"
    g, v = m.take(f"{conv}.weight_g"), m.take(f"{conv}.weight_v")
    if g is None:  # torch >= 2.1's parametrized naming
        g, v = m.take(f"{conv}.parametrizations.weight.original0"), m.take(f"{conv}.parametrizations.weight.original1")
    if g is not None and v is not None:
        m.out["pos_conv.weight"] = torch.from_numpy(g * v / np.sqrt(np.sum(v ** 2, axis=(0, 1), keepdims=True) + 1e-12))
        m.report.loaded.append("pos_conv.weight")
    m.put("pos_conv/bias", f"{conv}.bias")
    m.put("enc_norm/scale", f"{pre}encoder.layer_norm.weight")
    m.put("enc_norm/bias", f"{pre}encoder.layer_norm.bias")
    for i in range(cfg.num_layers):
        s, d = f"{pre}encoder.layers.{i}", f"layer_{i}"
        for proj, name in (("q_proj", "to_q"), ("k_proj", "to_k"), ("v_proj", "to_v"), ("out_proj", "to_out")):
            m.put(f"{d}/attn/{name}/kernel", f"{s}.attention.{proj}.weight")
            m.put(f"{d}/attn/{name}/bias", f"{s}.attention.{proj}.bias")
        for dst, src in (("norm1", "layer_norm"), ("ff1", "feed_forward.intermediate_dense"),
                         ("ff2", "feed_forward.output_dense"), ("norm2", "final_layer_norm")):
            m.put(f"{d}/{dst}/{'scale' if 'norm' in dst else 'kernel'}", f"{s}.{src}.weight")
            m.put(f"{d}/{dst}/bias", f"{s}.{src}.bias")
    return m.finish()


def _map_clip_layer(m: _Mapper, dst: str, src: str) -> None:
    m.put(f"{dst}/norm1/scale", f"{src}.layer_norm1.weight")
    m.put(f"{dst}/norm1/bias", f"{src}.layer_norm1.bias")
    for proj, name in (("q_proj", "to_q"), ("k_proj", "to_k"), ("v_proj", "to_v"), ("out_proj", "to_out")):
        m.put(f"{dst}/attn/{name}/kernel", f"{src}.self_attn.{proj}.weight")
        m.put(f"{dst}/attn/{name}/bias", f"{src}.self_attn.{proj}.bias")
    m.put(f"{dst}/norm2/scale", f"{src}.layer_norm2.weight")
    m.put(f"{dst}/norm2/bias", f"{src}.layer_norm2.bias")
    for fc in ("fc1", "fc2"):
        m.put(f"{dst}/{fc}/kernel", f"{src}.mlp.{fc}.weight")
        m.put(f"{dst}/{fc}/bias", f"{src}.mlp.{fc}.bias")


def import_clip_text(sd: StateDict, cfg) -> Dict[str, Any]:
    """transformers CLIPTextModel state dict -> the port's CLIPTextEncoder
    state dict (and "__report__"); SD-1.5's prompt encoder."""
    m = _Mapper(sd)
    pre = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    m.put("token_embedding/embedding", f"{pre}embeddings.token_embedding.weight")
    m.put("position_embedding", f"{pre}embeddings.position_embedding.weight")
    for i in range(cfg.text_layers):
        _map_clip_layer(m, f"layer_{i}", f"{pre}encoder.layers.{i}")
    m.put("final_norm/scale", f"{pre}final_layer_norm.weight")
    m.put("final_norm/bias", f"{pre}final_layer_norm.bias")
    m.used.update(k for k in sd if k.endswith("position_ids"))  # buffers
    return m.finish()


def import_clip_vision(sd: StateDict, cfg) -> Dict[str, Any]:
    """transformers CLIPVisionModelWithProjection state dict -> the port's
    CLIPVisionEncoder state dict (and "__report__"); the identity encoder."""
    m = _Mapper(sd)
    pre = "vision_model." if any(k.startswith("vision_model.") for k in sd) else ""
    m.put("class_embedding", f"{pre}embeddings.class_embedding")
    m.put("patch_embedding/kernel", f"{pre}embeddings.patch_embedding.weight")
    m.put("position_embedding", f"{pre}embeddings.position_embedding.weight")
    # transformers spells it "pre_layrnorm"
    pre_ln = "pre_layrnorm" if f"{pre}pre_layrnorm.weight" in sd else "pre_layernorm"
    m.put("pre_norm/scale", f"{pre}{pre_ln}.weight")
    m.put("pre_norm/bias", f"{pre}{pre_ln}.bias")
    for i in range(cfg.vision_layers):
        _map_clip_layer(m, f"layer_{i}", f"{pre}encoder.layers.{i}")
    m.put("post_norm/scale", f"{pre}post_layernorm.weight")
    m.put("post_norm/bias", f"{pre}post_layernorm.bias")
    m.put("visual_projection/kernel", "visual_projection.weight")
    m.used.update(k for k in sd if k.endswith("position_ids"))
    return m.finish()


@torch.no_grad()
def merge_imported(target: Union[nn.Module, Dict[str, torch.Tensor]],
                   imported: Dict[str, Any]) -> Union[nn.Module, Dict[str, torch.Tensor]]:
    """Overlay an import onto a module (in place; returned) or a state dict
    (a new one is returned): every imported tensor must name a target entry
    of its shape and takes the target's dtype and device. Entries absent
    from the import (the video-only parameters) keep their values."""
    own = target.state_dict() if isinstance(target, nn.Module) else target
    merged = dict(own)
    for k, v in imported.items():
        if k == "__report__":
            continue
        if k not in own:
            raise KeyError(f"imported key {k} not in the target")
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(own[k].shape)} vs {tuple(v.shape)}")
        merged[k] = v.to(dtype=own[k].dtype, device=own[k].device)
    if isinstance(target, nn.Module):
        for k in imported.keys() - {"__report__"}:
            own[k].copy_(merged[k])
        return target
    return merged
