"""Closed-loop serving: one client sends its next request when the last one's frames are back.

Set-up builds EMOPipeline on the seeded weights, makes a pool of seeded requests on the
device and warms every shape the window uses (a short request at the cell's sizes, then the
writer over every step's timestep). The window serves the pool's requests back to back until
`seconds` have passed; the request in flight finishes and counts, and the window ends at its
end. serve_frames_per_s is the frames of the completed requests over the window.

`correct` is decided after the window, on the program's state as it went (the pipeline
offers no other view of it): a recorder around the model's predict_noise and decode_latents
keeps what the program fed and produced at a few DDIM steps drawn from the seed. With the
program freed, the float32 reference (TF32 off) conditions each sampled request again from
its inputs and compares
  * state_gap: the latents of every recorded call against one another (both CFG halves,
    every window's copy of a frame) and step 0's against the initial noise: exact;
  * eps_gap: the CFG batch's noise predictions of the checked steps against the reference's
    on the same latents (writer, audio, text, denoiser);
  * step_gap: the program's next latents against the reference's CFG combine, window
    averaging and DDIM step from the program's predictions, over the part of the step that
    the prediction drives (the step less its eps-free part sqrt(a_prev / a_t) x): the
    widest element's gap over the largest element of that part. A maximum, not an L2 norm:
    where a few large predictions carry the norm, bfloat16 rounds them as coarsely as the
    rest while float8's per-tensor scale keeps the largest exact, and the norm would no
    longer tell the two apart;
  * frames_gap: the frames against the reference's decode of the latents the program decoded.
With ctx.control the float8 reference takes the program's place: its predictions, its step
from them and its decode are held to the same limits against the float32 reference (its one
copy of each frame's latents reads a state_gap of 0), and `correct` is decided on them.
"""

from __future__ import annotations

import gc
import time
import random
import traceback
from typing import Dict, List

import torch

from benchmark.harness import inputs as inp
from benchmark.harness.runtime import Checks, rel_l2, rel_max
from benchmark.harness.seeds import derive
from benchmark.harness.trace import Window, span
from benchmark.harness.weights import make_weights
from benchmark.reference import sampling as S
from benchmark.reference.emo import EMORef, param_shapes, vae_downscale
from benchmark.reference.pipeline import RequestRef
from benchmark.work import sites as W


def program_config(cfg: dict, tr: dict):
    """The port's Config: the configuration's sections, at the traffic's sizes."""
    from emox_torch.core.config import load_config

    sec = {k: dict(cfg[k]) for k in ("vae", "model", "audio", "clip", "diffusion", "inference")}
    size = tr["image_size"]
    sec["vae"]["sample_size"] = size
    sec["inference"].update(width=size, height=size, video_length=tr["frames"], num_inference_steps=tr["steps"],
                            guidance_scale=tr["guidance_scale"])
    sec["data"] = {"width": size, "height": size, "num_frames": tr["frames"]}
    return load_config(overrides=sec)


def step_calls(cfg: dict, steps: int, frames: int) -> List[List[List[int]]]:
    """Per DDIM step, the frames of each window of each reader call."""
    inf = cfg["inference"]
    out = []
    for s in range(steps):
        ws = S.windows(s, frames, inf["context_frames"], inf["context_stride"], inf["context_overlap"])
        out.append([ws[i:i + W.WINDOWS_PER_CALL] for i in range(0, len(ws), W.WINDOWS_PER_CALL)])
    return out


class Recorder:
    """Keeps, for every request, the input and output of the model's predict_noise at the
    calls in `keep` and the latents handed to decode_latents (references only: nothing is
    copied in the window)."""

    def __init__(self, model, keep):
        self.keep = set(keep)
        self.requests: List[Dict] = []
        self._predict, self._decode = model.predict_noise, model.decode_latents
        model.predict_noise, model.decode_latents = self.predict, self.decode

    def start(self) -> None:
        self.requests.append({"calls": {}, "decoded": None})
        self.call = 0

    def predict(self, noisy, *args, **kwargs):
        out = self._predict(noisy, *args, **kwargs)
        if self.call in self.keep:
            self.requests[-1]["calls"][self.call] = (noisy, out)
        self.call += 1
        return out

    def decode(self, latents, *args, **kwargs):
        self.requests[-1]["decoded"] = latents
        return self._decode(latents, *args, **kwargs)


def run(ctx) -> Dict:
    from emox_torch.infer.pipeline import EMOPipeline
    from emox_torch.models.emo import EMOModel
    from emox_torch.ops import launch_counts, reset_launch_counts

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    size, frames, steps, g = tr["image_size"], tr["frames"], tr["steps"], tr["guidance_scale"]
    lat = size // vae_downscale(cfg["vae"])
    dev, dt = ctx.device, ctx.dtype
    model = EMOModel(program_config(cfg, tr), dtype=dt, device=dev, seed=0)
    model.modules.load_state_dict(make_weights(param_shapes(cfg), derive(ctx.seed, "weights"), dev, dt), strict=True)
    pipe = EMOPipeline(model)
    gen = torch.Generator(device=dev).manual_seed(derive(ctx.seed, "requests"))
    pool = [inp.request_inputs(gen, dev, size, frames, dt, lat, cfg["model"]["speed_axes"], tr.get("prompts"))
            for _ in range(tr["pool"])]
    tok = inp.PromptTokenizer()

    def serve(req, n_steps, timings=None):
        return pipe(req["ref_image"], req["wav"], video_length=frames, num_inference_steps=n_steps,
                    guidance_scale=g, speeds=req["speeds"], face_mask=req["face_mask"], latents=req["latents"],
                    prompt=req["prompt"], negative_prompt=tr.get("negative_prompt", ""), tokenizer=tok,
                    timings=timings)

    # warm-up: a short request at the cell's sizes, then the writer over every step's timestep
    warm = inp.request_inputs(torch.Generator(device=dev).manual_seed(derive(ctx.seed, "warm-up")), dev, size,
                              frames, dt, lat, cfg["model"]["speed_axes"], tr.get("prompts"))
    serve(warm, tr["warmup_steps"])
    with torch.inference_mode():
        model.reference_outputs_for_steps(model.encode_images(warm["ref_image"]),
                                          torch.tensor(S.timesteps(cfg["diffusion"]["num_train_timesteps"], steps)))
    ctx.sync()

    calls = step_calls(cfg, steps, frames)
    first_call = [sum(len(c) for c in calls[:s]) for s in range(steps + 1)]
    rng = random.Random(derive(ctx.seed, "check"))
    checked_steps = sorted(rng.sample(range(steps - 1), min(tr["check_steps"], steps - 1)))
    keep = {c for k in checked_steps for c in range(first_call[k], first_call[k + 2])} | set(range(first_call[1]))
    rec = Recorder(model, keep)
    if ctx.fault:
        ctx.fault(pipe)

    videos, timings, failed = [], [], 0
    reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = ctx.age()
    with Window(ctx.trace, ctx.sync) as window:
        while True:
            req = pool[len(videos) % len(pool)]
            rec.start()
            t = {} if ctx.trace else None
            try:
                with span("bench.request", ctx.trace):
                    video = serve(req, steps, t)
                    ctx.sync()
            except Exception:  # a request that fails ends the window: the run is not correct
                traceback.print_exc()
                failed += 1
                break
            videos.append(video)
            timings.append(t)
            if window.elapsed() >= ctx.seconds:
                break
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    counts = launch_counts()
    done = len(videos)
    failed += sum(not bool(torch.isfinite(v.float()).all()) for v in videos)
    out = {"attempted": done + (1 if len(rec.requests) > done else 0), "failed": failed,
           "e2e": {"setup_s": setup_s, "serve_frames_per_s": done * frames / window.seconds},
           "window": window, "peak_bytes": peak}
    sites = W.request_sites(cfg, size, frames, steps)
    out["obs"] = {"requests": done, "steps": done * steps, "frames": done * frames, "window_s": window.seconds,
                  "timings": timings, "launches": counts, "sites": sites, "peak_bytes": peak,
                  "expected_launches": {k: v * done for k, v in W.expected_launches(sites).items()}}
    del pipe, model, warm, pool
    rec._predict = rec._decode = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if ctx.trace:
        from benchmark.work.flops import request_flops

        out["obs"]["flops_per_request"] = request_flops(cfg, size, frames, steps, bool(tr.get("prompts")))
    checked = sorted(rng.sample(range(done), min(tr["check_requests"], done)))
    t0 = time.perf_counter()
    out["checks"] = check(ctx, rec.requests, videos, checked, checked_steps, calls, first_call)
    out["check_s"] = time.perf_counter() - t0
    return out


def _state(noisy: torch.Tensor, windows: List[List[int]], x: torch.Tensor, gaps: List[float]) -> None:
    """Writes the frames of one call's latents (both CFG halves) into x [1, T, h, w, C] where
    unset (NaN), and records how far each copy lies from the frame's first copy."""
    n = len(windows)
    for half in (noisy[:n], noisy[n:]):
        for w, idx in enumerate(windows):
            for j, f in enumerate(idx):
                if torch.isnan(x[0, f, 0, 0, 0]):
                    x[0, f] = half[w, j].float()
                gaps.append(float((half[w, j].float() - x[0, f]).abs().max()))


def check(ctx, recorded, videos, checked, checked_steps, calls, first_call) -> Checks:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    frames, g = tr["frames"], tr["guidance_scale"]
    dev = ctx.device
    ts = S.timesteps(cfg["diffusion"]["num_train_timesteps"], tr["steps"]) + [-1]
    acp = S.alphas_cumprod(cfg["diffusion"])
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        W32 = {k: v.float() for k, v in make_weights(param_shapes(cfg), derive(ctx.seed, "weights"), dev,
                                                      ctx.dtype).items()}
        ref = EMORef(cfg, W32)
        ctl = EMORef(cfg, W32, precision="fp8") if ctx.control else None
        gen = torch.Generator(device=dev).manual_seed(derive(ctx.seed, "requests"))
        lat = tr["image_size"] // vae_downscale(cfg["vae"])
        pool = [inp.request_inputs(gen, dev, tr["image_size"], frames, ctx.dtype, lat, cfg["model"]["speed_axes"],
                                   tr.get("prompts")) for _ in range(tr["pool"])]
        tok = inp.PromptTokenizer()
        # the numbers of the program, and of the control in its place
        found = {who: {"state_gap": [], "eps_gap": [], "step_gap": [], "frames_gap": []}
                 for who in ("program", "control")}
        found["control"]["state_gap"].append(0.0)
        failed = {"program": sum(not bool(torch.isfinite(v.float()).all()) for v in videos), "control": 0}
        for r in checked:
            req, got = pool[r % len(pool)], recorded[r]
            ids = neg = None
            if req["prompt"] is not None:
                enc = lambda text: torch.from_numpy(tok.encode([text], cfg["clip"]["max_positions"])).to(dev)
                ids, neg = enc(req["prompt"]), enc(tr.get("negative_prompt", ""))
            cond = RequestRef(ref, req, frames, ids, neg)
            cond_ctl = RequestRef(ctl, req, frames, ids, neg) if ctl else None
            state = found["program"]["state_gap"]
            x0 = torch.full_like(req["latents"], float("nan"))
            for c, windows in enumerate(calls[0]):
                _state(got["calls"][first_call[0] + c][0], windows, x0, state)
            state.append(float((x0 - req["latents"]).abs().max()))
            for k in checked_steps:
                xs = []
                for s in (k, k + 1):
                    x = torch.full_like(req["latents"], float("nan"))
                    for c, windows in enumerate(calls[s]):
                        _state(got["calls"][first_call[s] + c][0], windows, x, state)
                    xs.append(x)
                xk, xk1 = xs

                def eps_of(c):
                    banks = c.banks(ts[k])
                    return [c.call_eps(xk[0, [f for w in windows for f in w]].reshape(len(windows), -1, *xk.shape[2:]),
                                       windows, ts[k], banks) for windows in calls[k]]

                eps_ref = eps_of(cond)
                base = S.ddim_step(acp, torch.zeros_like(xk), xk, ts[k], ts[k + 1])  # the step without eps
                eps_prog = [got["calls"][first_call[k] + c][1].float() for c in range(len(calls[k]))]
                found["program"]["eps_gap"].append(rel_l2(torch.cat(eps_prog), torch.cat(eps_ref)))
                # the step from the program's own predictions, against the reference's step from them
                want_prog = _ddim(acp, xk, eps_prog, calls[k], g, ts[k], ts[k + 1], None)
                found["program"]["step_gap"].append(rel_max(xk1 - base, want_prog - base))
                if cond_ctl:
                    eps_ctl = eps_of(cond_ctl)
                    found["control"]["eps_gap"].append(rel_l2(torch.cat(eps_ctl), torch.cat(eps_ref)))
                    have = _ddim(acp, xk, eps_ctl, calls[k], g, ts[k], ts[k + 1], ctl.q)
                    found["control"]["step_gap"].append(
                        rel_max(have - base, _ddim(acp, xk, eps_ctl, calls[k], g, ts[k], ts[k + 1], None) - base))
            decoded = got["decoded"][0].float()
            ref_frames = torch.cat([ref.decode(decoded[i:i + 1]) for i in range(frames)])
            found["program"]["frames_gap"].append(rel_l2(videos[r][0].float(), ref_frames))
            if ctl:
                ctl_frames = torch.cat([ctl.decode(decoded[i:i + 1]) for i in range(frames)])
                failed["control"] += not bool(torch.isfinite(ctl_frames).all())
                found["control"]["frames_gap"].append(rel_l2(ctl_frames, ref_frames))
        judged = "control" if ctx.control else "program"
        checks = Checks()
        for key, values in found[judged].items():
            checks.add(key, max(values, default=float("nan")), ctx.cell.limits[key])
        checks.add("failed_requests", failed[judged], ctx.cell.limits["failed_requests"])
        if ctx.control:
            ctx.detail["program"] = {key: max(v, default=float("nan")) for key, v in found["program"].items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return checks


@torch.no_grad()
def _ddim(acp, x, eps_calls, windows_calls, g, t, t_prev, rounding):
    """The program's step from the calls' CFG-batch predictions: combine the halves, average
    the windows per frame, take the DDIM step (the combined output rounded by `rounding`)."""
    total = torch.zeros_like(x)
    hits = torch.zeros(x.shape[1], device=x.device)
    for eps, windows in zip(eps_calls, windows_calls):
        n = len(windows)
        out = S.cfg_combine(eps[:n].float(), eps[n:].float(), g)
        if rounding is not None:
            out = rounding(out)
        for w, idx in enumerate(windows):
            total[0, idx] += out[w]
            hits[idx] += 1
    return S.ddim_step(acp, total / hits.reshape(1, -1, 1, 1, 1), x, t, t_prev)
