"""The work reckonings: the kernel sites against the calls the port makes, the model FLOPs,
and the roofline reader's refusal to divide mismatched work."""

from __future__ import annotations

from collections import Counter

import pytest
import torch

from conftest import tiny_sections

CUTOFF = 100  # at the tiny preset: the reader's sites (Lk 128) and the VAE's (256), not the writer's (64)


@pytest.fixture
def counted(monkeypatch):
    """Records the port's attention dispatches (rows, heads, Lq, Lk, head dim, whether the
    output carries a gradient) and FF sub-layer calls (rows, width)."""
    import emox_torch.nn.attention_blocks as blocks

    from benchmark.work import sites as W

    monkeypatch.setattr(W, "KERNEL_MIN_KV", CUTOFF)
    calls = {"attn": [], "ff": []}
    attend, ff = blocks.dot_product_attention_nlc, blocks.fused_ln_geglu_ff

    def attend_counted(q, k, v, heads, *a, **kw):
        out = attend(q, k, v, heads, *a, **kw)
        calls["attn"].append((q.shape[0], heads, q.shape[1], k.shape[1], q.shape[2] // heads, out.requires_grad))
        return out

    def ff_counted(x, *a, **kw):
        calls["ff"].append((x.numel() // x.shape[-1], x.shape[-1]))
        return ff(x, *a, **kw)

    monkeypatch.setattr(blocks, "dot_product_attention_nlc", attend_counted)
    monkeypatch.setattr(blocks, "fused_ln_geglu_ff", ff_counted)
    return calls


def _work(sites, kernel):
    out = Counter()
    for s in sites:
        if s.kernel == kernel:
            out[(s.flops, s.nbytes)] += s.count
    return out


@pytest.mark.parametrize("sd15,frames,steps", [(False, 3, 4), (True, 7, 3)])
def test_request_sites_are_the_calls_the_port_makes(counted, sd15, frames, steps):
    """One request at the tiny preset: every attention call past the cutoff is one
    attention-forward site of the reckoning, with its work, and every FF sub-layer one FF site;
    in windows, with a prompt, too."""
    from emox_torch.infer.pipeline import EMOPipeline
    from emox_torch.models.emo import EMOModel

    from benchmark.drivers.serve_closed_loop import program_config
    from benchmark.harness import inputs as inp
    from benchmark.work import sites as W

    cfg = tiny_sections(sd15)
    tr = {"image_size": 32, "frames": frames, "steps": steps, "guidance_scale": 7.5}
    pipe = EMOPipeline(EMOModel(program_config(cfg, tr), dtype=torch.float32, device="cpu", seed=0))
    req = inp.request_inputs(torch.Generator().manual_seed(0), "cpu", 32, frames, torch.float32, 16,
                             prompts=["a person talking"] if sd15 else None)
    pipe(req["ref_image"], req["wav"], video_length=frames, num_inference_steps=steps, speeds=req["speeds"],
         face_mask=req["face_mask"], latents=req["latents"], prompt=req["prompt"], tokenizer=inp.PromptTokenizer())
    sites = W.request_sites(cfg, 32, frames, steps)
    got = Counter(W.attn_fwd(*c[:5], 1)[2:] for c in counted["attn"] if c[3] >= CUTOFF)
    assert got == _work(sites, "flash_fwd_sm90")
    assert Counter(W.ff(m, c, 1)[2:] for m, c in counted["ff"]) == _work(sites, "ff_sm90")


def test_stage2_backward_sites_are_the_calls_that_carry_a_gradient(counted):
    """A stage-2 loss at the tiny preset: the attention calls past the cutoff whose output
    carries a gradient are the backward sites of the reckoning."""
    from emox_torch.diffusion.schedule import make_schedule
    from emox_torch.models.emo import EMOModel
    from emox_torch.train.stages import sample_draws, stage_loss_fn, trainable_mask

    from benchmark.drivers.train_steps import program_config
    from benchmark.harness import inputs as inp
    from benchmark.work import sites as W

    cfg = tiny_sections(False)
    tr = {"image_size": 32, "frames": 3, "batch": 2, "stage": 2, "learning_rate": 1e-3}
    config = program_config(cfg, tr, "unused")
    model = EMOModel(config, dtype=torch.float32, device="cpu", seed=0)
    model.set_trainable(trainable_mask(model.modules, 2))
    sched = make_schedule(config.diffusion)
    batch = inp.train_batch(torch.Generator().manual_seed(0), "cpu", 32, 2, 3)
    draws = sample_draws(config, sched, 2, batch, torch.Generator().manual_seed(1))
    stage_loss_fn(model, config, sched, 2)(batch, draws)
    got = Counter(W.attn_bwd(*c[:5], 1)[2:] for c in counted["attn"] if c[3] >= CUTOFF and c[5])
    assert got == _work(W.stage2_bwd_sites(cfg, 32, 2, 3), "flash_bwd_sm90")


def test_model_flops_of_the_flagship_request():
    """The flagship's 512^2 request on the meta device: per frame and reader forward, SD-1.5's
    UNet work at a 64 x 64 latent (0.68 TFLOP, 339 G multiply-adds, arXiv:2305.15798) plus
    the writer's tokens, audio and temporal attention; and the attention sites' own work is
    part of it."""
    import json

    from conftest import ROOT

    from benchmark.work import flops as F
    from benchmark.work import sites as W

    cfg = json.loads((ROOT / "benchmark/configs/emo-flagship.json").read_text())
    total = F.request_flops(cfg, 512, 16, 2, prompt=False)
    reader = total / (2 * 2 * 16)  # 2 steps, the CFG batch of 16 frames twice
    assert 0.6e12 < reader < 2.0e12
    attn = sum(s.flops * s.count for s in W.request_sites(cfg, 512, 16, 2) if s.kernel == "flash_fwd_sm90")
    assert attn < total


def test_roofline_reader_leaves_out_mismatched_work(capsys):
    from benchmark.harness.readers import roofline
    from benchmark.work.sites import attn_fwd

    site = attn_fwd(32, 5, 4096, 8192, 64, 10)
    trace = {"by_name": {"void emox::sm90::fwd_kernel<64>": {"count": 20, "s": 2.0}, "other": {"count": 1, "s": 1.0}}}
    obs = {"expected_launches": {"flash_fwd_sm90": 20}, "launches": {"flash_fwd_sm90": 20}, "trace": trace,
           "sites": [site], "requests": 2}
    share = roofline(obs, "flash_fwd_sm90", ("emox::sm90::fwd",), (), "requests")
    assert share == pytest.approx(100.0 * site.least_s() * 20 / 2.0)
    obs["launches"] = {"flash_fwd_sm90": 19}
    assert roofline(obs, "flash_fwd_sm90", ("emox::sm90::fwd",), (), "requests") is None
    assert "left out" in capsys.readouterr().err
