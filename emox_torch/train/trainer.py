"""Unified trainer for the port (counterpart of emox/train/trainer.py):
per-stage parameter freezing, the reference's optimizer chain, checkpoints
with torch.save, jsonl metrics. Stages 0 (the face nets), 1-3 (denoising)
and 5 (the VAE) run through one loop; the stage's loss and draws come from
emox_torch.train.stages, its checkpoints go to `stage<N>/` under
train.checkpoint_dir, and a later stage starts from an earlier one's
(`load_params_from_stage`: stage 1 from the stage-5 VAE, for one).

  * structural freezing: the modules hold every leaf in the compute dtype;
    only the trainable leaves take a gradient (requires_grad), and each has
    an fp32 master kept by the optimizer, copied into the module after every
    applied update. Frozen leaves get no gradient buffer and no master.
  * the optimizer is the reference's optax chain
    MultiSteps(apply_if_finite(chain(clip_by_global_norm, adamw(schedule))))
    on the masters, with torch.optim.AdamW as the AdamW (its decoupled
    weight decay is optax's, algebraically).
  * PyTorch keeps the state in the modules and the optimizer, so a train
    step updates the model and `Trainer.state` in place where the reference
    returns a new state.

What waits for a later slice (ROADMAP.md, Queue 1 item 8): adafactor, the
TensorBoard and wandb metric sinks, the profiler capture, and the
reference's retry of steps dropped by its TPU tunnel's compiler.
"""

from __future__ import annotations

import json
import math
import os
import re
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Union

import torch

from emox_torch.core.config import Config, TrainConfig
from emox_torch.core.dtypes import policy_from_names
from emox_torch.diffusion.schedule import make_schedule
from emox_torch.models.emo import EMOModel
from emox_torch.train.stages import sample_draws, stage_loss_fn, trainable_mask

_MAX_CONSECUTIVE_NONFINITE = 10  # optax.apply_if_finite's max_consecutive_errors in the reference


def learning_rate(tc: TrainConfig, count: int) -> float:
    """The learning rate of the count-th applied update: optax's
    warmup_cosine_decay_schedule(0, lr, warmup, max(num_steps, warmup + 1))
    with warmup, else the constant rate."""
    if tc.warmup_steps <= 0:
        return tc.learning_rate
    warmup = tc.warmup_steps
    if count < warmup:
        return tc.learning_rate * count / warmup
    decay_steps = max(tc.num_steps, warmup + 1) - warmup
    t = min(count - warmup, decay_steps)
    return tc.learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every tensor, in fp32 (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


class Optimizer:
    """The reference's optimizer over a list of fp32 master tensors, built
    by `make_optimizer`. `step(grads)` takes one micro-step's gradients and
    returns True when it applied an update (AdamW stepped)."""

    def __init__(self, params: List[torch.Tensor], tc: TrainConfig):
        if tc.optimizer == "adafactor":
            raise NotImplementedError("train.optimizer='adafactor' waits for a later slice of the port "
                                      "(ROADMAP.md, Queue 1 item 8)")
        if tc.optimizer != "adamw":
            raise ValueError(f"unknown optimizer {tc.optimizer!r}")
        self.tc = tc
        self.params = list(params)
        self.adamw = torch.optim.AdamW(self.params, lr=tc.learning_rate, betas=(tc.adam_b1, tc.adam_b2),
                                       eps=tc.adam_eps, weight_decay=tc.weight_decay)
        self.every = max(1, tc.gradient_accumulation)
        self.mini_step = 0  # MultiSteps: micro-steps into the current window
        self.acc: Optional[List[torch.Tensor]] = None  # running mean of the window's grads
        self.count = 0  # applied updates (the schedule's step count)
        self.notfinite_count = 0  # consecutive non-finite updates (apply_if_finite)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> bool:
        if self.every > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            # the running mean of optax.MultiSteps(use_grad_mean=True)
            for a, g in zip(self.acc, grads):
                a.add_(g.sub(a), alpha=1.0 / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.every:
                # MultiSteps runs the inner chain on every micro-step and
                # keeps 0 * its update. Once apply_if_finite gives up on a
                # non-finite mean, that update is non-finite where the
                # clipped mean is, and 0 * it puts NaN into the masters there.
                if self.notfinite_count >= _MAX_CONSECUTIVE_NONFINITE:
                    norm = global_norm(self.acc)
                    if not bool(torch.isfinite(norm)):
                        for p, a in zip(self.params, self.acc):
                            p.add_(a.div(norm).mul(self.tc.grad_clip_norm).mul(0.0))
                return False
            self.mini_step = 0
            applied = self._update(self.acc)
            # optax.MultiSteps resets the window as (1 - emit) * acc, so a
            # NaN or inf of this window stays, as NaN, in every later one
            for a in self.acc:
                a.mul_(0.0)
            return applied
        return self._update(grads)

    def _update(self, grads: List[torch.Tensor]) -> bool:
        norms = torch.stack(torch._foreach_norm(grads))
        # apply_if_finite: a non-finite update is skipped (state untouched)
        # until more than 10 come in a row. A gradient whose fp32 norm
        # overflows counts as non-finite here.
        if bool(torch.isfinite(norms).all()):
            self.notfinite_count = 0
        else:
            self.notfinite_count += 1
            if self.notfinite_count <= _MAX_CONSECUTIVE_NONFINITE:
                return False
        g_norm = float(torch.linalg.vector_norm(norms))
        if not g_norm < self.tc.grad_clip_norm:  # clip_by_global_norm: t / norm * max_norm, in place
            torch._foreach_div_(grads, g_norm)
            torch._foreach_mul_(grads, self.tc.grad_clip_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = learning_rate(self.tc, self.count)
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.adamw.state_dict(), "mini_step": self.mini_step, "acc": self.acc,
                "count": self.count, "notfinite_count": self.notfinite_count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.mini_step = state["mini_step"]
        self.acc = None if state["acc"] is None else [a.to(p.device) for a, p in zip(state["acc"], self.params)]
        self.count = state["count"]
        self.notfinite_count = state["notfinite_count"]


def make_optimizer(config: Config, params: List[torch.Tensor]) -> Optimizer:
    """The optimizer over the TRAINABLE leaves' fp32 masters only: clip by
    global norm, AdamW with warmup-cosine, skip non-finite updates, and
    gradient accumulation (train.gradient_accumulation micro-steps)."""
    return Optimizer(params, config.train)


@dataclass
class TrainState:
    """step: micro-steps taken; masters: fp32 masters of the trainable
    leaves by parameter name (the frozen leaves live in the model only);
    ema: EMA of the masters (train.ema_decay > 0) — frozen leaves equal
    their EMA, so only trainable ones are kept."""

    step: int
    masters: Dict[str, torch.Tensor]
    optimizer: Optimizer
    ema: Optional[Dict[str, torch.Tensor]]


class MetricsLogger:
    """jsonl metrics stream, one record per call: {"step", "time", metrics...}."""

    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class Checkpointer:
    """Checkpoints as torch.save files `step_<n>.pt` in one directory,
    keeping the newest `keep`. A payload holds "step", "params" (every
    parameter, trainable ones as their fp32 masters), "opt_state" and, with
    EMA, "ema_params" (trainable leaves only)."""

    _NAME = re.compile(r"step_(\d+)\.pt$")

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> List[int]:
        found = (self._NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Dict[str, Any]) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save(dict(payload, step=int(step)), tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.keep] if self.keep > 0 else []:
            os.remove(self._path(old))

    def restore(self, step: int) -> Dict[str, Any]:
        """The payload saved at `step`, its tensors on the CPU."""
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore_params(self, step: Optional[int] = None, use_ema: bool = False) -> Optional[Dict[str, torch.Tensor]]:
        """Only the parameters (to start stage N+1 from stage N); with
        use_ema, the EMA of the trainable leaves where the checkpoint has
        one (the weights one serves). None when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        payload = self.restore(step)
        params = dict(payload["params"])
        if use_ema and payload.get("ema_params") is not None:
            params.update(payload["ema_params"])
        return params


class Trainer:
    def __init__(self, config: Config, model: Optional[EMOModel] = None,
                 device: Optional[Union[str, torch.device]] = None):
        """Builds the model (random weights from train.seed, in the compute
        dtype, on `device`: the CUDA card unless told otherwise) unless one
        is given, freezes it for train.stage and sets up the optimizer,
        checkpoints and metrics under train.checkpoint_dir."""
        self.config = config
        tc = config.train
        self.policy = policy_from_names(tc.param_dtype, tc.compute_dtype)
        if tc.frozen_dtype == "param" and self.policy.param_dtype != self.policy.compute_dtype:
            raise NotImplementedError(
                "train.frozen_dtype='param' with a compute dtype other than the param dtype: the port's "
                "modules hold one dtype; fp32 frozen masters wait for a later slice (ROADMAP.md, Queue 1 item 8)"
            )
        if model is None:
            model = EMOModel(config, dtype=self.policy.compute_dtype, device=device, seed=tc.seed)
        if model.dtype != self.policy.compute_dtype:
            raise ValueError(f"the model holds {model.dtype}, train.compute_dtype is {tc.compute_dtype}")
        self.model = model
        self.device = model.device
        self.sched = make_schedule(config.diffusion, device=model.device)
        self.stage = tc.stage
        self.loss_fn = stage_loss_fn(model, config, self.sched, self.stage)
        self.mask = trainable_mask(model.modules, self.stage)
        model.set_trainable(self.mask)
        params = dict(model.modules.named_parameters())
        self._train_names = [n for n, m in self.mask.items() if m]
        self._train_params = [params[n] for n in self._train_names]
        self.state = self._fresh_state()
        self.ckpt = Checkpointer(os.path.join(tc.checkpoint_dir, f"stage{self.stage}"), tc.keep_checkpoints)
        self.best_ckpt = Checkpointer(os.path.join(tc.checkpoint_dir, f"stage{self.stage}_best"), 1)
        self.best_eval_loss = float("inf")
        self.logger = MetricsLogger(tc.checkpoint_dir, f"stage{self.stage}")

    # ---- state -----------------------------------------------------------------
    def _fresh_state(self, step: int = 0) -> TrainState:
        # a master shares the module's storage when the compute dtype is the
        # param dtype, and is an fp32 copy otherwise
        masters = {n: p.detach().to(self.policy.param_dtype) for n, p in zip(self._train_names, self._train_params)}
        ema = ({n: m.clone() for n, m in masters.items()} if self.config.train.ema_decay > 0 else None)
        opt = make_optimizer(self.config, list(masters.values()))
        return TrainState(step=step, masters=masters, optimizer=opt, ema=ema)

    @torch.no_grad()
    def _sync_modules(self) -> None:
        """Copy the masters into the modules' compute-dtype leaves."""
        for p, m in zip(self._train_params, self.state.masters.values()):
            if p.data_ptr() != m.data_ptr():
                p.copy_(m)

    def trainable_names(self) -> List[str]:
        return list(self._train_names)

    def _payload(self) -> Dict[str, Any]:
        params = {n: p.detach() for n, p in self.model.modules.named_parameters()}
        params.update(self.state.masters)
        payload = {"params": params, "opt_state": self.state.optimizer.state_dict()}
        if self.state.ema is not None:
            payload["ema_params"] = self.state.ema
        return payload

    @torch.no_grad()
    def _load_params(self, params: Dict[str, torch.Tensor]) -> None:
        own = dict(self.model.modules.named_parameters())
        missing = sorted(set(own) - set(params))
        if missing:
            raise ValueError(f"checkpoint lacks parameters {missing[:8]}")
        for n, p in own.items():
            p.copy_(params[n])

    # ---- steps -------------------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor], generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One train step with draws from `generator` -> metrics (tensors on
        the model's device). Updates the model and self.state in place."""
        draws = sample_draws(self.config, self.sched, self.stage, batch, generator)
        return self.train_step_with_draws(batch, draws)

    def loss_and_grads(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        """(metrics, grads): the loss's metrics (detached) and its gradients
        over the trainable leaves only, in the param dtype, in the order of
        trainable_names(). Changes no parameter."""
        self.model.train()
        loss, metrics = self.loss_fn(batch, draws)
        grads = torch.autograd.grad(loss, self._train_params, allow_unused=True)
        # a leaf that does not reach the loss gets zeros, as jax.grad gives it
        grads = self.policy.cast_to_param([torch.zeros_like(p) if g is None else g
                                           for g, p in zip(grads, self._train_params)])
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        return metrics, grads

    def train_step_with_draws(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        """train_step with the loss's random numbers given (sample_draws)."""
        metrics, grads = self.loss_and_grads(batch, draws)
        if self.state.optimizer.step(grads):
            self._sync_modules()
        ema = self.state.ema
        if ema is not None:
            d = self.config.train.ema_decay
            with torch.no_grad():
                for e, m in zip(ema.values(), self.state.masters.values()):
                    e.mul_(d).add_(m, alpha=1.0 - d)
        self.state.step += 1
        return metrics

    @torch.no_grad()
    def evaluate(self, batches: Iterable[Dict[str, torch.Tensor]], num_batches: int = 8) -> Dict[str, float]:
        """Mean loss over held-out batches with a fixed draw seed."""
        self.model.train(False)
        gen = torch.Generator(device=self.device).manual_seed(self.config.train.seed + 1234)
        losses = []
        for i, batch in enumerate(batches):
            if i >= num_batches:
                break
            loss, _ = self.loss_fn(batch, sample_draws(self.config, self.sched, self.stage, batch, gen))
            losses.append(float(loss))
        return {"eval_loss": sum(losses) / len(losses) if losses else float("nan")}

    def fit(self, batches: Iterable[Dict[str, torch.Tensor]], num_steps: Optional[int] = None,
            eval_batches: Optional[Iterable[Dict[str, torch.Tensor]]] = None) -> Dict[str, float]:
        tc = self.config.train
        num_steps = num_steps or tc.num_steps
        gen = torch.Generator(device=self.device).manual_seed(tc.seed + 1)
        start = self.state.step
        last: Dict[str, float] = {}
        it = iter(batches)
        for step in range(start, num_steps):
            t0 = time.perf_counter()
            metrics = self.train_step(next(it), gen)
            if step == start:
                # the first step pays for the kernel builds and the libraries' warm-up
                float(metrics["loss"])
                self.logger.log(step + 1, {"first_step_s": time.perf_counter() - t0})
            if (step + 1) % tc.log_every == 0 or step + 1 == num_steps:
                last = {k: float(v) for k, v in metrics.items()}
                self.logger.log(step + 1, last)
            if tc.eval_every and eval_batches is not None and (step + 1) % tc.eval_every == 0:
                ev = self.evaluate(eval_batches)
                self.logger.log(step + 1, ev)
                last.update(ev)
                if ev["eval_loss"] == ev["eval_loss"] and ev["eval_loss"] < self.best_eval_loss:
                    self.best_eval_loss = ev["eval_loss"]
                    self.best_ckpt.save(step + 1, self._payload())
            if tc.checkpoint_every and (step + 1) % tc.checkpoint_every == 0:
                self.ckpt.save(step + 1, self._payload())
        if tc.checkpoint_every and self.state.step % tc.checkpoint_every != 0:
            self.ckpt.save(self.state.step, self._payload())
        return last

    # ---- checkpoints -----------------------------------------------------------------
    def resume(self) -> int:
        """Restore the latest checkpoint of this stage (train.resume) and
        return its step, or 0."""
        latest = self.ckpt.latest_step()
        if latest is None or not self.config.train.resume:
            return 0
        payload = self.ckpt.restore(latest)
        self._load_params(payload["params"])
        self.state = self._fresh_state(step=payload["step"])
        with torch.no_grad():
            for n, m in self.state.masters.items():
                m.copy_(payload["params"][n])
            if self.state.ema is not None:
                for n, e in self.state.ema.items():
                    e.copy_(payload["ema_params"][n])
        self.state.optimizer.load_state_dict(payload["opt_state"])
        return int(latest)

    def load_params_from_stage(self, stage: int) -> bool:
        """Start from a previous stage's latest checkpoint (fresh optimizer)."""
        prev = Checkpointer(os.path.join(self.config.train.checkpoint_dir, f"stage{stage}"))
        params = prev.restore_params()
        if params is None:
            return False
        self._load_params(params)
        self.state = self._fresh_state(step=self.state.step)
        with torch.no_grad():
            for n, m in self.state.masters.items():
                m.copy_(params[n])
        return True

    def close(self) -> None:
        self.logger.close()
