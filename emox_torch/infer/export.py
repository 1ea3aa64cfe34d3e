"""Export the denoise step for serving (counterpart of emox/infer/export.py).

The reference traces `EMOModel.predict_noise` once with `jax.export` and
serialises the program, its Pallas kernels as custom calls inside it. Here
`torch.export` traces the port's step, and every kernel the eager step
launches is a registered op of the `emox_torch` namespace
(emox_torch/ops/registry.py), so the graph holds `emox_torch::<kernel>` at
each such site and never the kernel's plain formula. The switches that pick
the sites (EMOX_ATTENTION_IMPL, EMOX_FF_IMPL, EMOX_LN_QKV,
EMOX_GROUPNORM_IMPL, and the K/V length from which "auto" takes a kernel)
are read while tracing, so they are fixed in the artifact, as the
reference's trace fixes them; `export_switches` reports them.

The parameters are an input of the exported program, as in the reference,
so the artifact holds the program and no weight:

    exp = export_denoise_step(model, num_frames=16, image_size=256)
    save_exported(exp, "emox_step.pt2")
    ...
    fn = load_exported("emox_step.pt2")
    eps = fn(params, noisy, t, ref_latent, audio, speeds, face_mask)

`params` is `dict(model.modules.named_parameters())` of a model of the same
configuration (the port's checkpoints hold exactly these names); the inputs
are the reference's seven in its layout and order: noisy [B, T, h, w, 4],
t [B] int64, ref_latent [B, h, w, 4], audio windows [B, T, 2 * context + 1,
D], speeds [B, T] (with model.speed_axes > 1 [B, T, axes]), face mask
[B, H, W, 1], each on the card the step was exported on, in the exported
dtype.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import torch
import torch.nn as nn

from emox_torch.models.emo import EMOModel

SWITCHES = ("EMOX_ATTENTION_IMPL", "EMOX_FF_IMPL", "EMOX_LN_QKV", "EMOX_GROUPNORM_IMPL", "EMOX_FUSED_QKV")


class _Denoise(nn.Module):
    """predict_noise as a module whose parameters are the model's."""

    def __init__(self, model: EMOModel):
        super().__init__()
        self.net = model.modules
        self.model = (model,)  # a tuple: the EMOModel is no module

    def forward(self, noisy, t, ref_latent, audio, speeds, face_mask):
        return self.model[0].predict_noise(noisy, t, ref_latent, audio_windows=audio, speeds=speeds,
                                           face_mask=face_mask)


class _Step(nn.Module):
    """The exported program: the step with the parameters as its first
    input. It registers no parameter, so the artifact holds none."""

    def __init__(self, model: EMOModel):
        super().__init__()
        self.denoise = (_Denoise(model),)

    def forward(self, params: Dict[str, torch.Tensor], noisy, t, ref_latent, audio, speeds, face_mask):
        named = {f"net.{k}": v for k, v in params.items()}
        return torch.func.functional_call(self.denoise[0], named, (noisy, t, ref_latent, audio, speeds, face_mask))


def export_switches() -> Dict[str, object]:
    """The switches a trace fixes: each EMOX_* variable the kernel sites read
    (None where unset) and the attention's K/V cutoff and default impl."""
    from emox_torch.ops.attention import KERNEL_MIN_KV, attention_default_impl

    return {**{k: os.environ.get(k) for k in SWITCHES}, "attention_impl": attention_default_impl(),
            "KERNEL_MIN_KV": KERNEL_MIN_KV}


def step_inputs(model: EMOModel, num_frames: int = 16, image_size: int = 256, batch: int = 1,
                dtype: torch.dtype = torch.bfloat16, gen: torch.Generator = None) -> tuple:
    """The step's inputs after the parameters, on the model's device: noise
    from `gen` (zeros without one), t 500 and a centred disc as face mask."""
    cfg = model.config
    lat = image_size // cfg.vae.downscale
    dev = model.device
    axes = cfg.model.speed_axes
    draw = (lambda *s: torch.randn(s, generator=gen, device=gen.device).to(dev, dtype)) if gen is not None else (
        lambda *s: torch.zeros(s, device=dev, dtype=dtype))
    yy, xx = torch.meshgrid(torch.arange(image_size, device=dev), torch.arange(image_size, device=dev), indexing="ij")
    disc = (((yy - image_size / 2) ** 2 + (xx - image_size / 2) ** 2) < (image_size / 3) ** 2).to(dtype)
    return (draw(batch, num_frames, lat, lat, cfg.model.in_channels),
            torch.full((batch,), 500, dtype=torch.int64, device=dev),
            draw(batch, lat, lat, cfg.model.in_channels),
            draw(batch, num_frames, 2 * cfg.audio.context_frames + 1, cfg.audio.hidden_dim),
            torch.zeros((batch, num_frames) + ((axes,) if axes > 1 else ()), device=dev, dtype=dtype),
            disc[None, :, :, None].expand(batch, image_size, image_size, 1).contiguous())


def export_denoise_step(model: EMOModel, num_frames: int = 16, image_size: int = 256, batch: int = 1,
                        dtype: torch.dtype = torch.bfloat16) -> torch.export.ExportedProgram:
    """Export the fully conditioned denoise step (predict_noise with the
    reference image, audio windows, speeds and face mask) at these shapes,
    traced on the model's device under torch.no_grad (so no activation
    checkpointing enters the graph), with the switches as they are set now.
    Returns a torch.export.ExportedProgram."""
    params = dict(model.modules.named_parameters())
    args = (params, *step_inputs(model, num_frames, image_size, batch, dtype))
    with torch.no_grad():
        exported = torch.export.export(_Step(model), args, strict=False)
    # the artifact keeps neither the example inputs (the weights among them)
    # nor each node's Python stack trace (half the graph's bytes)
    exported.example_inputs = None
    for node in exported.graph.nodes:
        node.meta.pop("stack_trace", None)
    return exported


def kernel_nodes(exported: torch.export.ExportedProgram) -> Dict[str, int]:
    """The exported graph's calls of the port's registered ops, by name."""
    from emox_torch.ops.registry import NAMESPACE

    counts: Dict[str, int] = {}
    for node in exported.graph.nodes:
        if node.op == "call_function" and getattr(node.target, "namespace", None) == NAMESPACE:
            name = node.target._opname
            counts[name] = counts.get(name, 0) + 1
    return counts


def save_exported(exported: torch.export.ExportedProgram, path: str) -> str:
    torch.export.save(exported, path)
    return path


def load_exported(path: str) -> Callable:
    """The exported step as a callable fn(params, noisy, t, ref_latent,
    audio, speeds, face_mask) -> eps. Importing emox_torch.ops registers the
    ops the graph calls; their CUDA implementations launch the kernels."""
    import emox_torch.ops  # noqa: F401  (registers the emox_torch ops)

    exported = torch.export.load(path)
    step = exported.module()
    child = lambda spec, i: spec.child(i) if hasattr(spec, "child") else spec.children_specs[i]
    names = child(child(exported.call_spec.in_spec, 0), 0).context  # (args, kwargs) -> args -> params

    def fn(params, noisy, t, ref_latent, audio, speeds, face_mask):
        with torch.no_grad():
            return step({k: params[k] for k in names}, noisy, t, ref_latent, audio, speeds, face_mask)

    return fn
