"""Back-to-back training steps of emox_torch's Trainer on batches made on the device.

Set-up builds one Trainer on the seeded weights, makes a pool of distinct seeded batches and
drives the trainer through its first `check_steps` steps (its warm-up too), reading from it
what `correct` compares: each step's loss, the first gradient per trainable leaf as AdamW
took it (its first moment after one step over 1 - beta1), and after the last of them each
leaf's change from its start. The same trainer then runs the window: one train_step after
another, each ending where its metrics reach the host; the step in flight finishes and
counts. train_frames_per_s is batch x frames x steps completed over the window.

After the window, with the trainer freed, the float32 reference (TF32 off) takes the same
weights, batches and draws (the draws again from the same generator) through the same steps,
and compares those of these numbers that the cell's limits name:
  * loss_gap: the worst step's |loss - reference| / reference;
  * grad_gap: the worst leaf's |norm - reference norm| / max(reference norm, median leaf's);
  * change_gap: the same of each leaf's change after the steps, over the leaves whose
    reference gradient reaches a thousandth of the median leaf's (below it, AdamW moves a
    leaf by round-off alone).
With ctx.control the float8 reference takes the program's place: its losses, gradients and
changes through the same steps are held to the same limits against the float32 reference,
and `correct` is decided on them.
"""

from __future__ import annotations

import gc
import time
import math
import traceback
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import inputs as inp
from benchmark.harness.runtime import Checks
from benchmark.harness.seeds import derive
from benchmark.harness.trace import Window, span
from benchmark.harness.weights import make_weights
from benchmark.reference import sampling as S
from benchmark.reference.emo import EMORef, param_shapes, vae_downscale
from benchmark.reference.pipeline import LOSS_ROWS, stage2_loss
from benchmark.work import sites as W

TRAINED = ("_temporal", "_audio")  # stage 2 trains the denoiser's temporal and audio layers


def trainable(names) -> List[str]:
    return sorted(n for n in names if n.startswith("denoiser.") and any(k in n for k in TRAINED))


def program_config(cfg: dict, tr: dict, checkpoint_dir: str):
    from emox_torch.core.config import load_config

    sec = {k: dict(cfg[k]) for k in ("vae", "model", "audio", "clip", "diffusion", "inference")}
    size = tr["image_size"]
    sec["vae"]["sample_size"] = size
    sec["data"] = {"width": size, "height": size, "num_frames": tr["frames"], "batch_size": tr["batch"]}
    sec["train"] = dict(cfg["train"], stage=tr["stage"], learning_rate=tr["learning_rate"],
                        checkpoint_dir=checkpoint_dir, resume=False)
    return load_config(overrides=sec)


def run(ctx) -> Dict:
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts
    from emox_torch.train.trainer import Trainer

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    if tr["stage"] != 2:
        raise ValueError("the train_steps driver's reference is stage 2's loss")
    size, b, t = tr["image_size"], tr["batch"], tr["frames"]
    dev = ctx.device
    config = program_config(cfg, tr, str(ctx.scratch / "train"))
    # the weights in the masters' type: the trainer keeps them as its masters and computes
    # with their rounding to the compute type
    master = getattr(torch, cfg["train"]["param_dtype"])
    model = EMOModel(config, dtype=master, device=dev, seed=0)
    model.modules.load_state_dict(make_weights(param_shapes(cfg), derive(ctx.seed, "weights"), dev, master),
                                  strict=True)
    trainer = Trainer(config, model=model)
    names = trainer.trainable_names()
    gen = torch.Generator(device=dev).manual_seed(derive(ctx.seed, "batches"))
    pool = [inp.train_batch(gen, dev, size, b, t, cfg["audio"]["context_frames"]) for _ in range(tr["pool"])]
    draws = torch.Generator(device=dev).manual_seed(derive(ctx.seed, "draws"))
    if ctx.fault:
        ctx.fault(trainer)

    # the first steps: warm-up, and what the reference follows
    start = {n: m.detach().clone() for n, m in trainer.state.masters.items()}
    losses, grads = [], {}
    opt = trainer.state.optimizer
    for i in range(tr["check_steps"]):
        losses.append(float(trainer.train_step(pool[i], draws)["loss"]))
        if i == 0:
            state = opt.adamw.state
            b1 = config.train.adam_b1
            grads = {n: float(state[m]["exp_avg"].double().norm()) / (1.0 - b1) if m in state else 0.0
                     for n, m in trainer.state.masters.items()}
    change = {n: float((m.double() - start[n].double()).norm()) for n, m in trainer.state.masters.items()}
    del start
    ctx.sync()

    failed, steps = 0, 0
    reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = ctx.age()
    with Window(ctx.trace, ctx.sync) as window:
        while True:
            try:
                with span("bench.train_step", ctx.trace):
                    loss = float(trainer.train_step(pool[(tr["check_steps"] + steps) % len(pool)], draws)["loss"])
            except Exception:  # a step that fails ends the window: the run is not correct
                traceback.print_exc()
                failed += 1
                break
            steps += 1
            failed += not math.isfinite(loss)
            if window.elapsed() >= ctx.seconds:
                break
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    counts = launch_counts()
    sites = W.stage2_bwd_sites(cfg, size, b, t)
    out = {"attempted": steps + (failed > 0), "failed": failed,
           "e2e": {"setup_s": setup_s, "train_frames_per_s": steps * b * t / window.seconds},
           "window": window, "peak_bytes": peak,
           "obs": {"steps": steps, "window_s": window.seconds, "launches": counts, "sites": sites, "peak_bytes": peak,
                   "expected_launches": {k: v * steps for k, v in W.expected_launches(sites).items()}}}
    trainer.close()
    del trainer, model, pool, opt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if ctx.trace:
        from benchmark.work.flops import train_step_flops

        out["obs"]["flops_per_step"] = train_step_flops(cfg, size, b, t, names, cfg["train"]["uncond_ratio"])
    t0 = time.perf_counter()
    out["checks"] = check(ctx, names, losses, grads, change)
    out["check_s"] = time.perf_counter() - t0
    return out


def follow(ctx, precision: str, names: List[str]):
    """The reference through the first steps: (losses, first-gradient norms, change norms)."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    size, b, t = tr["image_size"], tr["batch"], tr["frames"]
    tc = cfg["train"]
    W32 = make_weights(param_shapes(cfg), derive(ctx.seed, "weights"), dev, getattr(torch, tc["param_dtype"]))
    params = [W32[n].requires_grad_(True) for n in names]
    start = [p.detach().clone() for p in params]
    ref = EMORef(cfg, W32, precision=precision, checkpoint=True)
    gen = torch.Generator(device=dev).manual_seed(derive(ctx.seed, "batches"))
    batches = [inp.train_batch(gen, dev, size, b, t, cfg["audio"]["context_frames"]) for _ in range(tr["check_steps"])]
    draws = torch.Generator(device=dev).manual_seed(derive(ctx.seed, "draws"))
    acp = S.alphas_cumprod(cfg["diffusion"])
    lat = size // vae_downscale(cfg["vae"])
    opt = S.AdamW(params, tr["learning_rate"], tc["adam_b1"], tc["adam_b2"], tc["adam_eps"], tc["weight_decay"],
                  tc["grad_clip_norm"])
    losses, grads = [], {}
    for i, batch in enumerate(batches):
        d = inp.stage2_draws(draws, batch, lat, cfg["diffusion"]["num_train_timesteps"], tc["uncond_ratio"])
        # the batch's mean loss and its gradients, a block of rows at a time (each block's
        # mean weighted by its share of the rows), so that the reference fits beside nothing
        loss, g = 0.0, None
        for r in range(0, b, LOSS_ROWS):
            rows = slice(r, min(b, r + LOSS_ROWS))
            part = stage2_loss(ref, batch, d, acp, cfg["audio"]["context_frames"], rows) * ((rows.stop - r) / b)
            g_part = torch.autograd.grad(part, params)
            loss += float(part.detach())
            g = g_part if g is None else [x.add_(y) for x, y in zip(g, g_part)]
            del part, g_part
        losses.append(loss)
        clipped = opt.step(g)
        if i == 0:
            grads = {n: float(c.double().norm()) for n, c in zip(names, clipped)}
    change = {n: float((p.detach().double() - s.double()).norm()) for n, p, s in zip(names, params, start)}
    return losses, grads, change


def gaps(names, losses, grads, change, want, detail=None) -> Dict[str, float]:
    w_losses, w_grads, w_change = want
    med = float(np.median([w_grads[n] for n in names]))
    moved = [n for n in names if w_grads[n] >= 1e-3 * med]
    grad_gap, grad_leaf = S.leaf_gap(grads, w_grads, names)
    change_gap, change_leaf = S.leaf_gap(change, w_change, moved)
    if detail is not None:
        detail.update(losses=losses, reference_losses=w_losses, moved=len(moved), leaves=len(names),
                      grad_leaf=[grad_leaf, grads[grad_leaf], w_grads[grad_leaf]],
                      change_leaf=[change_leaf, change[change_leaf], w_change[change_leaf]])
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, w_losses)),
            "grad_gap": grad_gap, "change_gap": change_gap}


def check(ctx, program_names, losses, grads, change) -> Checks:
    limits = ctx.cell.limits
    names = trainable(param_shapes(ctx.cell.config))
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        want = follow(ctx, "fp32", names)
        same = set(names) == set(program_names)
        checks = Checks()
        # the control trains the reference's own leaves
        checks.add("leaf_set_gap", 0 if ctx.control else len(set(names) ^ set(program_names)), limits["leaf_set_gap"])
        if ctx.control:
            if same:
                ctx.detail["program"] = gaps(names, losses, grads, change, want)
            gc.collect()
            found = gaps(names, *follow(ctx, "fp8", names), want, ctx.detail)
        elif same:
            found = gaps(names, losses, grads, change, want, ctx.detail)
        else:
            return checks
        for k, v in found.items():
            if k in limits:  # the cell's limits name the numbers compared; the rest are printed
                checks.add(k, v, limits[k])
            else:
                ctx.detail.setdefault("not_compared", {})[k] = v
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return checks
