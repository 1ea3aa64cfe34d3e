#!/usr/bin/env python3
"""Why the bf16 windowed request depends on how its windows are grouped, on one NVIDIA H100.

    python3 chip_probe_windows.py

The distributed phase's request (chip_smoke._dist_spec: the flagship at
256^2, 48 frames, 10 DDIM steps, CFG 7.5, the same seeded weights and
inputs) in three parts, each printed as one JSON line:

  request   the request in bf16 and in float32 (TF32 off), each with
            WINDOWS_PER_CALL 4 (the default), 2 and 1: each run's max
            |latent| gap to its type's default, and the bf16 default's gap
            to the float32 default, which is bf16's own error: the floor a
            grouping's gap is read against;
  call      step 0's windows denoised four to a call and one to a call: the
            max gap of the denoiser's outputs after one call, and the gap of
            the bf16 call of four to the float32 one;
  ops       in that call of four windows, layer by layer: every module of
            the model (from the UNet down to each Dense, Conv and norm) and
            every kernel op (emox_torch::*) run again on the first quarter
            of its rows (dim 0, and the same rows of every argument that
            shares it) alone and held against the same rows of its output
            in the call. Per class of module or op, the calls, those whose
            rows changed with their call-mates, the largest change relative
            to the output's max |value|, and the layers where it was
            largest. A class whose own children are unchanged but which
            changes holds the op that depends on its call-mates.

The card's name and power limit come first. Exits non-zero without a card.
"""

from __future__ import annotations

import contextlib
import json
import sys
import tempfile

WPCS = (4, 2, 1)


def _rows(n: int) -> int:
    """The rows a check keeps: a quarter of dim 0, else a half; 0 to skip."""
    return n // 4 if n % 4 == 0 and n >= 4 else n // 2 if n % 2 == 0 else 0


def _cut(a, n: int, k: int):
    """The first k of n rows of a, where a's dim 0 folds them: a tensor of
    n rows keeps k, one of d rows (d dividing n, rows folded batch-major, as
    frames are into the batch) keeps k * d / n; anything else stays."""
    import torch

    if not isinstance(a, torch.Tensor) or not a.dim() or a.shape[0] < 2 or n % a.shape[0] or (k * a.shape[0]) % n:
        return a
    return a[:k * a.shape[0] // n]


class _Tally:
    """Per kind of layer or op: calls, checked, changed, the largest gaps."""

    def __init__(self):
        self.kinds = {}

    def add(self, kind: str, where: str, got, want) -> None:
        k = self.kinds.setdefault(kind, {"calls": 0, "checked": 0, "changed": 0, "max_abs": 0.0, "max_rel": 0.0,
                                         "worst": []})
        k["calls"] += 1
        if got is None:
            return
        k["checked"] += 1
        gap = float((got.float() - want.float()).abs().max())
        rel = gap / max(float(want.float().abs().max()), 1e-30)
        if gap > 0:
            k["changed"] += 1
        k["max_abs"], k["max_rel"] = max(k["max_abs"], gap), max(k["max_rel"], rel)
        k["worst"] = sorted(k["worst"] + [(rel, where)], reverse=True)[:4]

    def report(self):
        return {kind: dict(v, worst=[{"rel": r, "at": w} for r, w in v["worst"]]) for kind, v in self.kinds.items()}


@contextlib.contextmanager
def checking(model, tally: _Tally):
    """Each call of the model's modules and of the kernel ops run again on
    its first rows alone: every tensor argument whose dim 0 is the first
    argument's cut to them (see the module docstring)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from emox_torch.ops import registry

    busy = [False]

    def first(out):
        return out[0] if isinstance(out, (tuple, list)) else out

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = str(func)
            if busy[0] or not name.startswith("emox_torch."):
                return out
            lead = next(a for a in args if isinstance(a, torch.Tensor))
            k = _rows(lead.shape[0])
            if not k:
                tally.add(name, name, None, None)
                return out
            cut = [_cut(a, lead.shape[0], k) for a in args]
            busy[0] = True
            try:
                alone = first(func(*cut, **kwargs))
            finally:
                busy[0] = False
            tally.add(name, f"{name} {tuple(lead.shape)}", alone, first(out)[:k])
            return out

    def hook(mod, args, kwargs, out, where):
        if busy[0] or not args or not isinstance(args[0], torch.Tensor) or not isinstance(out, torch.Tensor):
            return
        n = args[0].shape[0]
        k = _rows(n)
        kind = type(mod).__name__
        if not k or out.dim() == 0 or out.shape[0] != n:
            tally.add(kind, where, None, None)
            return
        busy[0] = True
        try:
            alone = mod(*(_cut(a, n, k) for a in args), **{key: _cut(v, n, k) for key, v in kwargs.items()})
        except RuntimeError:  # an argument whose dim 0 is not a fold of the rows
            tally.add(kind, where, None, None)
            return
        finally:
            busy[0] = False
        tally.add(kind, f"{where} {tuple(args[0].shape)}", alone, out[:k])

    handles = [mod.register_forward_hook(lambda m, a, kw, o, where=where: hook(m, a, kw, o, where), with_kwargs=True)
               for where, mod in model.named_modules()]
    try:
        with registry.through_ops(), Ops():
            yield
    finally:
        for h in handles:
            h.remove()


def probe(cfg, request, device: str, steps: int):
    """The three parts' lines for the request of `cfg` (chip_smoke's model
    and weights) with `request`'s (image, wav, speeds, mask) on `device`."""
    import torch

    import chip_smoke as cs
    from emox_torch.infer import pipeline
    from emox_torch.models.emo import EMOModel

    default_wpc = pipeline.WINDOWS_PER_CALL
    lat, call, ops = {}, {}, {}
    with cs.switches():
        for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            model = EMOModel(cfg, dtype=dtype, device=device, seed=0)
            cs._fill_zero_init(model, seed=8)
            pipe = pipeline.EMOPipeline(model)
            img, wav, speeds, mask = (t.to(device, dtype) for t in request)
            denoise, step0 = pipe._denoise_windows, []

            def spy(*args, **kwargs):
                if not step0:
                    step0.append((args, kwargs))
                return denoise(*args, **kwargs)

            pipe._denoise_windows = spy
            math_ = cs._float32_math() if dtype == torch.float32 else contextlib.nullcontext()
            with math_:
                for wpc in WPCS:
                    pipeline.WINDOWS_PER_CALL = wpc
                    try:
                        lat[(tag, wpc)] = pipe.generate_latents(
                            img, wav, video_length=cfg.inference.video_length, num_inference_steps=steps,
                            guidance_scale=7.5, speeds=speeds, face_mask=mask,
                            generator=torch.Generator(device=device).manual_seed(31)).float().cpu()
                    finally:
                        pipeline.WINDOWS_PER_CALL = default_wpc
                args, kwargs = step0[0]
                tally = _Tally()
                with torch.inference_mode():
                    with checking(model.modules, tally):
                        four = denoise(*args, **kwargs)
                    pipeline.WINDOWS_PER_CALL = 1
                    try:
                        one = denoise(*args, **kwargs)
                    finally:
                        pipeline.WINDOWS_PER_CALL = default_wpc
            call[tag] = {"windows": int(args[0].shape[0]), "max_abs": float((four.float() - one.float()).abs().max()),
                         "scale": float(one.float().abs().max()), "out": four.float().cpu()}
            ops[tag] = tally.report()
            del model, pipe, four, one, step0
            if device == "cuda":
                torch.cuda.empty_cache()
    gap = lambda a, b: float((lat[a] - lat[b]).abs().max())
    call["bf16_to_f32"] = float((call["bf16"].pop("out") - call["f32"].pop("out")).abs().max())
    return [{"probe": "request", "config": f"flagship 256^2, {cfg.inference.video_length} frames, "
             f"{steps} DDIM steps, CFG 7.5", "latent_scale": float(lat[("f32", 4)].abs().max()),
             "bf16_to_f32": gap(("bf16", 4), ("f32", 4)),
             "to_default": {tag: {str(w): gap((tag, w), (tag, 4)) for w in WPCS} for tag in ("bf16", "f32")},
             "finite": all(bool(torch.isfinite(v).all()) for v in lat.values())},
            {"probe": "call", **call}] + [{"probe": "ops", "dtype": tag, "kinds": rep} for tag, rep in ops.items()]


def main() -> int:
    import torch

    import chip_smoke as cs
    from emox_torch.ops import build

    if not torch.cuda.is_available():
        print("chip_probe_windows: no CUDA device; the probe runs on the card only", file=sys.stderr)
        return 2
    print(cs.smi_line(), flush=True)
    build.build()
    with tempfile.TemporaryDirectory() as tmp:
        spec = cs._dist_spec(tmp)
    for line in probe(spec["serve_cfg"], spec["request"], "cuda", cs.DIST_STEPS):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
