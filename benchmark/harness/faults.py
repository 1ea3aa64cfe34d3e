"""Faults planted under a run, to read what the numbers compared make of them (run.py --fault,
and the tests): a step that returns its state unchanged, half of the batch left out, and an
answer altered where it is produced. The exchange between cards has no place in a one-card
cell. `plant` returns what undoes it."""

from __future__ import annotations

from typing import Callable

import torch


def _serve(name: str, pipe) -> Callable[[], None]:
    import emox_torch.infer.pipeline as pipeline

    if name == "unchanged_step":  # every DDIM step returns the latents it was given
        step = pipeline.ddim_step
        pipeline.ddim_step = lambda sched, out, sample, *a, **k: sample
        return lambda: setattr(pipeline, "ddim_step", step)
    if name == "half_batch":  # the CFG batch's second half left out: the first half's output in its place
        predict = pipe.model.predict_noise

        def half(*a, **k):
            out = predict(*a, **k)
            h = out.shape[0] // 2
            return torch.cat([out[:h], out[:h]])

        pipe.model.predict_noise = half
    elif name == "altered_answer":  # the clip's first frame turned negative where it is decoded
        decode = pipe.model.decode_latents

        def altered(*a, **k):
            frames = decode(*a, **k).clone()
            frames[:, 0] = -frames[:, 0]
            return frames

        pipe.model.decode_latents = altered
    else:
        raise ValueError(f"unknown fault {name!r}")
    return lambda: None


def _train(name: str, trainer) -> Callable[[], None]:
    if name == "unchanged_step":  # the optimizer takes no step
        trainer.state.optimizer.step = lambda grads: False
    elif name == "half_batch":  # the loss over the first half of the rows, its mean taken there
        loss_fn = trainer.loss_fn

        def half(batch, draws):
            b, t = batch["frames"].shape[:2]
            rows = lambda x: x[: b // 2] if x.shape[0] == b else x[: (b // 2) * t]
            return loss_fn({k: rows(v) for k, v in batch.items()}, {k: rows(v) for k, v in draws.items()})

        trainer.loss_fn = half
    elif name == "altered_answer":  # the largest trained leaf's gradient doubled where it is produced
        loss_and_grads = trainer.loss_and_grads

        def altered(batch, draws):
            metrics, grads = loss_and_grads(batch, draws)
            max(grads, key=lambda g: float(g.norm())).mul_(2.0)
            return metrics, grads

        trainer.loss_and_grads = altered
    else:
        raise ValueError(f"unknown fault {name!r}")
    return lambda: None


PLANT = {"serve_closed_loop": _serve, "train_steps": _train}
NAMES = ("unchanged_step", "half_batch", "altered_answer")


def plant(driver: str, name: str, target) -> Callable[[], None]:
    return PLANT[driver](name, target)
