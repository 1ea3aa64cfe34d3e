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

import jax
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
from tests.test_torch_head_dims import _bwd_formulas
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


@pytest.mark.parametrize("lq,lk", [(64, 64), (40, 72)], ids=["aligned", "ragged"])
def test_plain_d512_backward_matches_pallas_interpret(lq, lk):
    """dq, dk and dv of one head of dim 512: the plain backward (the d-512
    kernels' plain version) against jax.grad through the reference's packed
    kernels (forward and the dq / dkv backward pair) in interpret mode."""
    rng = np.random.default_rng(43)
    n, heads, d = 2, 1, 512
    q, k, v, g = (rng.standard_normal((n, l, heads * d)).astype(np.float32) for l in (lq, lk, lk, lq))
    scale = d ** -0.5
    loss = lambda a, b, c: jnp.sum(jattn.flash_attention_nlc(a, b, c, heads, interpret=True) * j(g))
    want = jax.grad(loss, argnums=(0, 1, 2))(j(q), j(k), j(v))
    out, lse = tattn.attention_nlc_plain(t(q), t(k), t(v), heads, scale)
    got = tattn.attention_nlc_bwd_plain(t(q), t(k), t(v), out, lse, t(g), heads, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and rel(a, b) <= FP32_TOL, name


@pytest.fixture
def d512_card(monkeypatch):
    """The packed backward's card path on CPU tensors at head dim 512: the
    d-512 launchers replaced by stand-ins that assert what the kernels take
    (head-split views [B, H, L, 512] with 16-byte aligned rows; lse and delta
    [B, H, Lq_pad] fp32 contiguous, Lq_pad the next multiple of 64 rows,
    padded with +inf and 0) and write the plain result into the outputs the
    wrapper allocated; head dims above 512 reach a stand-in of the wide
    backward; every other backward launcher fails. Returns the launches."""
    seen = []

    def stand_in(name, dtype):
        def launch(q, k, v, dout, lse, delta, dq, dk, dv, scale):
            assert q.dtype == dtype and q.shape[-1] == 512 and (dk is None) == (dv is None)
            for x in (q, k, v, dout, *(y for y in (dq, dk, dv) if y is not None)):
                assert tattn._rows_aligned(x) and x.dtype == dtype, x.stride()
            b, h, lq, _ = q.shape
            for x in (lse, delta):
                assert x.dtype == torch.float32 and x.is_contiguous() and x.shape[:2] == (b, h)
                assert x.shape[2] % 64 == 0 and lq <= x.shape[2] < lq + 64
            assert torch.isposinf(lse[..., lq:]).all() and not delta[..., lq:].any()
            for out, want in zip((dq, dk, dv), _bwd_formulas(q, k, v, dout, lse[..., :lq], delta[..., :lq], scale)):
                if out is not None:
                    out.copy_(want)
            seen.append(name)
        return launch

    def refuse(*a, **kw):
        raise AssertionError("head dim 512 reached another backward kernel")

    monkeypatch.setattr(tattn, "_on_card_or_cpu", lambda name, x: True)
    monkeypatch.setattr(tattn, "flash_bwd_d512_sm90", stand_in("flash_bwd_d512_sm90", torch.bfloat16))
    monkeypatch.setattr(tattn, "flash_bwd_d512_f32", stand_in("flash_bwd_d512_f32", torch.float32))
    for name in ("flash_bwd_sm90", "flash_bwd_f32_sm90", "flash_bwd_d256_sm90"):
        monkeypatch.setattr(tattn, name, refuse)

    def wide(q, k, v, dout, lse, delta, dq, dk, dv, scale):
        assert q.shape[-1] > 512 and lse.shape[2] % 64 == 0
        lq = q.shape[2]
        for out, want in zip((dq, dk, dv), _bwd_formulas(q, k, v, dout, lse[..., :lq], delta[..., :lq], scale)):
            if out is not None:
                out.copy_(want)
        seen.append("flash_bwd_wide")

    monkeypatch.setattr(tattn, "flash_bwd_wide", wide)
    yield seen
    tattn.flash_attention_nlc_bwd.launches = 0


def _d512_bwd_inputs(dtype, n=2, lq=70, lk=45, heads=1, seed=44):
    rng = np.random.default_rng(seed)
    q, k, v, g = (t(rng.standard_normal((n, l, heads * 512)).astype(np.float32), dtype) for l in (lq, lk, lk, lq))
    o, lse = tattn.attention_nlc_plain(q, k, v, heads, 512 ** -0.5)
    return q, k, v, o, lse, g


def test_d512_backward_is_refused_for_the_kernel(d512_card):
    """The packed backward at head dim 512, which only VAE pretraining
    (stage 5) runs: bf16 reaches flash_bwd_d512_sm90 and float32
    flash_bwd_d512_f32 (two heads, Lq 70: six rows past a 64-row tile of
    the lse padding), with the gradients of the plain version. Head dims
    257-511 are padded to 512 and take the same kernels, as the reference
    computes them; head dims above 512 are no longer refused: d 1024 reaches
    the wide backward (flash_bwd_wide, a stand-in here) with the plain
    backward's gradients, as the reference computes them."""
    for dtype, name in ((torch.bfloat16, "flash_bwd_d512_sm90"), (torch.float32, "flash_bwd_d512_f32")):
        q, k, v, o, lse, g = _d512_bwd_inputs(dtype, heads=2)
        want = tattn.attention_nlc_bwd_plain(q, k, v, o, lse, g, 2, 512 ** -0.5)
        got = tattn.flash_attention_nlc_bwd(q, k, v, o, lse, g, 2)
        assert d512_card[-1] == name
        for a, b in zip(got, want):
            assert a.dtype == dtype and rel(a, b.float().numpy()) <= (BF16_TOL if dtype == torch.bfloat16 else FP32_TOL)
    assert d512_card == ["flash_bwd_d512_sm90", "flash_bwd_d512_f32"]
    x = torch.zeros(1, 8, 384)
    grads = tattn._flash_bwd_kernel(x, x, x, x, torch.zeros(1, 8, 1), x, 1, 384 ** -0.5, True, True)
    assert d512_card[-1] == "flash_bwd_d512_f32" and all(gr.shape == x.shape for gr in grads)
    q, k, v, g = (t(np.random.default_rng(1024 + i).standard_normal((1, 8, 1024)).astype(np.float32))
                  for i in range(4))
    o, lse = tattn.attention_nlc_plain(q, k, v, 1, 1024 ** -0.5)
    grads = tattn._flash_bwd_kernel(q, k, v, o, lse, g, 1, 1024 ** -0.5, True, True)
    assert d512_card[-1] == "flash_bwd_wide"
    for a, b in zip(grads, tattn.attention_nlc_bwd_plain(q, k, v, o, lse, g, 1, 1024 ** -0.5)):
        assert a.shape == q.shape and rel(a, b.numpy()) <= FP32_TOL


D512_SUBSETS = [(dtype, need) for dtype in ("bfloat16", "float32") for need in ("dq", "dkv")]


@pytest.mark.parametrize("dtype,need", D512_SUBSETS, ids=[f"{a}-{b}" for a, b in D512_SUBSETS])
def test_d512_backward_subsets(d512_card, dtype, need):
    """Only dq, or only dk and dv, at head dim 512: the others are None and
    one launch reaches the kernel of the type."""
    dt = getattr(torch, dtype)
    q, k, v, o, lse, g = _d512_bwd_inputs(dt)
    need_dq = need == "dq"
    got = tattn.flash_attention_nlc_bwd(q, k, v, o, lse, g, 1, need_dq=need_dq, need_dkv=not need_dq)
    want = tattn.attention_nlc_bwd_plain(q, k, v, o, lse, g, 1, 512 ** -0.5)
    assert d512_card == ["flash_bwd_d512_sm90" if dt == torch.bfloat16 else "flash_bwd_d512_f32"]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if (name == "dq") != need_dq:
            assert a is None, name
        else:
            tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
            assert a.dtype == dt and rel(a, b.float().numpy()) <= tol, name


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


def test_vae_with_width_512_gradients_match_the_reference(monkeypatch):
    """The gradients of a VAE whose mid-attention is one head of dim 512,
    through the packed kernel's route (the autograd function's backward,
    its plain version on the CPU) against jax.grad through the reference VAE
    with its Pallas kernels (forward and backward) interpreted: the input's
    gradient and every parameter's, flattened, <= 1e-5 relative L2."""
    from emox_torch.interop.from_flax import state_dict_from_flax

    calls = _count_routes(monkeypatch, cutoff=(VAE_IMAGE // 2) ** 2)
    monkeypatch.setenv("EMOX_ATTENTION_IMPL", "pallas_interpret")
    rng = np.random.default_rng(45)
    x = rng.uniform(-1, 1, (2, VAE_IMAGE, VAE_IMAGE, 3)).astype(np.float32)
    w_img = rng.standard_normal(x.shape).astype(np.float32)
    w_lat = rng.standard_normal((2, VAE_IMAGE // 2, VAE_IMAGE // 2, 4)).astype(np.float32)
    jmod = JAutoencoderKL(JVAEConfig(**VAE_512))
    params = flax_module_params(jmod, jnp.asarray(x))

    def jloss(p, xx):
        img, dist = jmod.apply({"params": p}, xx)
        return jnp.sum(img * j(w_img)) + jnp.sum(dist.mean * j(w_lat))

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(params, j(x))
    tmod = torch_module(AutoencoderKL(VAEConfig(**VAE_512)), params).requires_grad_(True)
    monkeypatch.setenv("EMOX_ATTENTION_IMPL", "auto")  # the port as on the card
    xt = t(x).requires_grad_()
    img, dist = tmod(xt)
    names = [n for n, _ in tmod.named_parameters()]
    grads = torch.autograd.grad((img * t(w_img)).sum() + (dist.mean * t(w_lat)).sum(),
                                [xt, *tmod.parameters()])
    assert calls == {"flash_attn_nlc_fwd": 2, "flash_attn_fwd": 0}
    assert rel(grads[0], want_x) <= FP32_TOL
    want = state_dict_from_flax(jax.tree.map(np.asarray, want_p))
    got_flat = torch.cat([g.reshape(-1) for g in grads[1:]]).double()
    want_flat = torch.cat([want[n].reshape(-1) for n in names]).double()
    assert float((got_flat - want_flat).norm() / want_flat.norm()) <= FP32_TOL
    mid = names.index("encoder.mid_attn.attn.to_q.weight")
    assert rel(grads[1 + mid], want["encoder.mid_attn.attn.to_q.weight"].numpy()) <= FP32_TOL


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
