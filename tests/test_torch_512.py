"""The port at 512^2 against the reference, on the CPU: the packed attention
at head dim 512 (the VAE's single-head mid-attention, which K1 takes at
512^2), a VAE whose last width is 512 with its mid-attention on the packed
kernel's route, the 512^2 flagship configuration, and the count of
attention-kernel launches per request that chip_smoke.py asserts on the
card.

The VAE is the flagship's shape cut to two levels (base 128, multipliers
(1, 4): widths 128 and 512) at a 16x16 image, with the K/V cutoff lowered
to its 64 latent tokens; the reference runs its Pallas kernel in interpret
mode there (EMOX_ATTENTION_IMPL=pallas_interpret; tests/conftest.py pins
xla). Tolerances: float32 <= 1e-5 relative L2, bf16 two bf16 steps.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from emox.core import presets as jpresets
from emox.core.config import VAEConfig as JVAEConfig
from emox.models.vae import AutoencoderKL as JAutoencoderKL
from emox.ops import attention as jattn
from emox_torch.core import presets as tpresets
from emox_torch.core.config import VAEConfig
from emox_torch.infer.pipeline import EMOPipeline
from emox_torch.models.vae import AutoencoderKL
from emox_torch.ops import attention as tattn
from tests.test_torch_bridge import FRAMES, flax_module_params, model_params, no_kernel_launches, torch_module  # noqa: F401 (autouse fixture)
from tests.test_torch_ops import BF16_TOL, FP32_TOL, j, rel, t

VAE_512 = dict(base_channels=128, channel_multipliers=(1, 4), num_res_blocks=1, norm_groups=32)
VAE_IMAGE = 16


def _count_routes(monkeypatch, cutoff: int) -> dict:
    """Lower the K/V cutoff and count the calls that take each attention
    kernel's route (the packed K1, the strided K5), under the impl the card
    defaults to ("auto"; tests/conftest.py pins xla)."""
    calls = {"flash_attn_nlc_fwd": 0, "flash_attn_fwd": 0}

    def count(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setenv("EMOX_ATTENTION_IMPL", "auto")
    monkeypatch.setattr(tattn, "KERNEL_MIN_KV", cutoff)
    monkeypatch.setattr(tattn, "flash_attention_nlc", count("flash_attn_nlc_fwd", tattn.flash_attention_nlc))
    monkeypatch.setattr(tattn, "flash_attention", count("flash_attn_fwd", tattn.flash_attention))
    return calls


@pytest.mark.parametrize("lq,lk", [(64, 64), (40, 100)], ids=["aligned", "ragged"])
def test_plain_d512_matches_pallas_interpret(lq, lk):
    """One head of dim 512, as the VAE's mid-attention: output and lse of
    the plain version against the reference's packed kernel in interpret
    mode (lk 100 runs its masked path)."""
    rng = np.random.default_rng(40)
    n, heads, d = 2, 1, 512
    q, k, v = (rng.standard_normal((n, l, heads * d)).astype(np.float32) for l in (lq, lk, lk))
    scale = d ** -0.5
    want, want_lse = jattn._flash_impl_nlc(j(q), j(k), j(v), heads, scale, interpret=True, return_lse=True)
    got, got_lse = tattn.attention_nlc_plain(t(q), t(k), t(v), heads, scale)
    assert rel(got, want) <= FP32_TOL
    assert rel(got_lse, np.asarray(want_lse)[:, :lq]) <= FP32_TOL
    # bf16 operands: fp32 inside, one rounding of the output
    bf = [t(a, torch.bfloat16) for a in (q, k, v)]
    want_bf = jattn.flash_attention_nlc(*(j(a, jnp.bfloat16) for a in (q, k, v)), heads, interpret=True)
    got_bf = tattn.flash_attention_nlc(*bf, heads)
    assert got_bf.dtype == torch.bfloat16 and rel(got_bf, want_bf) <= BF16_TOL


def test_d512_backward_is_refused_for_the_kernel():
    """The backward kernels take head dims 64 and 128; at d 512 the wrapper
    names stage 5 (VAE pretraining), the path that would need it, before
    anything reaches the card. The plain backward still runs on the CPU."""
    q = torch.zeros(1, 8, 512)
    lse = torch.zeros(1, 8, 1)
    with pytest.raises(ValueError, match="stage 5"):
        tattn._flash_bwd_kernel(q, q, q, q, lse, q, 1, 512 ** -0.5, True, True)
    dq, dk, dv = tattn.flash_attention_nlc_bwd(q, q, q, q, lse, q, 1)
    assert dq.shape == dk.shape == dv.shape == q.shape


def test_vae_with_width_512_matches_the_reference(monkeypatch):
    """Encode (posterior mean) and decode through a VAE whose mid-attention
    is one head of dim 512 on the packed kernel's route, against the
    reference VAE with its Pallas kernel interpreted."""
    calls = _count_routes(monkeypatch, cutoff=(VAE_IMAGE // 2) ** 2)
    monkeypatch.setenv("EMOX_ATTENTION_IMPL", "pallas_interpret")
    x = np.random.default_rng(41).uniform(-1, 1, (2, VAE_IMAGE, VAE_IMAGE, 3)).astype(np.float32)
    jmod = JAutoencoderKL(JVAEConfig(**VAE_512))
    params = flax_module_params(jmod, jnp.asarray(x))
    want_img, want_dist = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = torch_module(AutoencoderKL(VAEConfig(**VAE_512)), params)
    monkeypatch.setenv("EMOX_ATTENTION_IMPL", "auto")  # the port as on the card
    with torch.no_grad():
        got_img, got_dist = tmod(t(x))
    assert tmod.encoder.mid_attn.attn.heads == 1 and tmod.encoder.mid_attn.attn.to_q.weight.shape == (512, 512)
    assert calls == {"flash_attn_nlc_fwd": 2, "flash_attn_fwd": 0}  # encode and decode
    assert got_dist.mean.shape == want_dist.mean.shape == (2, VAE_IMAGE // 2, VAE_IMAGE // 2, 4)
    assert rel(got_dist.mean, want_dist.mean) <= FP32_TOL
    assert got_img.shape == want_img.shape == x.shape
    assert rel(got_img, want_img) <= FP32_TOL


def test_flagship_512_config_matches_the_reference():
    """flagship_config(image_size=512), as bench.py builds its 512^2 cells,
    field for field; at 512^2 the VAE mid-attention (64^2 tokens, d 512)
    and the reader's level-0 and level-1 sites reach the kernel cutoff."""
    got, want = tpresets.flagship_config(image_size=512), jpresets.flagship_config(image_size=512)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.data.height == got.inference.width == got.vae.sample_size == 512
    assert chip_smoke.attn_launches_per_request(got, 10) == {"flash_attn_nlc_fwd": 107, "flash_attn_fwd": 0}
    assert chip_smoke.attn_launches_per_request(tpresets.flagship_config(), 10)["flash_attn_nlc_fwd"] == 50


@pytest.mark.parametrize("name", ["tiny", "tiny_sd15"])
def test_attention_launches_per_request_match_the_code(monkeypatch, name):
    """chip_smoke.attn_launches_per_request against the calls one serving
    request makes on each attention kernel's route, with the cutoff lowered
    to the reader's sites (reference tokens appended) and the VAE's
    mid-attention: 4 reader sites x 2 steps + 2."""
    from tests.test_torch_pipeline import _request

    steps = 2
    _, params, tcfg = model_params(name)
    from emox_torch.models.emo import EMOModel

    pipe = EMOPipeline(EMOModel(tcfg, device="cpu", seed=1).load_flax(params))
    req = _request(tcfg, seed=42)
    calls = _count_routes(monkeypatch, cutoff=128)
    video = pipe(t(req["image"]), t(req["wav"]), video_length=FRAMES, num_inference_steps=steps, guidance_scale=3.0,
                 speeds=t(req["speeds"]), face_mask=t(req["mask"]), latents=t(req["latents"]),
                 prompt="a face" if name == "tiny_sd15" else None)
    assert torch.isfinite(video).all()
    want = chip_smoke.attn_launches_per_request(tcfg, steps)
    assert calls == want and sum(want.values()) == 4 * steps + 2
