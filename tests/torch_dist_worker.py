"""One rank of the CPU world that tests/test_torch_distributed.py spawns.

    python tests/torch_dist_worker.py RANK WORLD DIR

The rank joins a gloo world through `file://DIR/store`, reads the inputs
the test wrote to DIR/inputs.pt, runs every distributed check of the port
on them (meshes, the batch-slicing names, the TP plan, ring attention, the
temporal transformer on the ring, stage-2 steps on two meshes, the windowed
sampler across context ranks, sparse-causal steps over context, clips whose
frames stay whole on every context rank, stages 0 and 5 across data x
context ranks, adafactor under tensor parallelism and its checkpoint) and,
on rank 0, writes what it found to DIR/results.pt. It imports torch and the
port only: no JAX.
"""

from __future__ import annotations

import datetime
import os
import sys
import traceback

import torch
import torch.distributed as dist

TIMEOUT_S = 60  # a collective that waits longer than this fails the rank


def _gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    from emox_torch.comm.runtime import all_gather

    return all_gather(t.contiguous(), group, dim=dim)


def check_meshes(inputs):
    """Each config's mesh over the world (and local_mesh(context=2)): dim
    names, the rank layout and this rank's coordinate, or the error it
    raises."""
    from emox_torch.core.mesh import create_mesh, local_mesh

    out = {}
    for name, cfg in inputs["mesh_configs"].items():
        try:
            m = create_mesh(cfg)
            out[name] = {"names": m.mesh_dim_names, "ranks": m.mesh.tolist(), "coord": m.get_coordinate()}
        except ValueError as e:
            out[name] = {"error": str(e)}
    m = local_mesh(context=2)
    out["local_mesh"] = {"names": m.mesh_dim_names, "ranks": m.mesh.tolist(), "coord": m.get_coordinate()}
    return out


def check_batch_names(inputs):
    """The batch-slicing names on a data 2 x context 2 mesh: every rank's
    block from put_batch, shard_batch and with_context_sharding (gathered
    to every rank), and batch_sharding's specs there and on data 4."""
    from emox_torch.comm.sharding import shard_batch, with_context_sharding
    from emox_torch.core.config import MeshConfig
    from emox_torch.core.mesh import batch_sharding, create_mesh, put_batch

    mesh = create_mesh(MeshConfig(data=2, context=2, model=1))
    b = inputs["batch_names"]
    mine = {"put_batch": put_batch(b["put_batch"], mesh, frame_axis=1), "shard_batch": shard_batch(b["shard_batch"], mesh),
            "with_context_sharding": {k: with_context_sharding(torch.from_numpy(v), mesh)
                                      for k, v in b["with_context_sharding"].items()}}
    blocks = [None] * dist.get_world_size()
    dist.all_gather_object(blocks, mine)
    dp = create_mesh(MeshConfig(data=4, context=1, model=1))
    specs = {(name, ndim, fa): batch_sharding(m, ndim, fa) for name, m in (("dp_cp", mesh), ("dp", dp))
             for ndim, fa in ((1, None), (3, None), (4, 1), (5, 2))}
    return {"blocks": blocks, "specs": specs}


def check_ring(inputs, mesh):
    """ring_attention and ring_frame_attention on this rank's blocks: the
    outputs and the gradients of sum(out^2), gathered whole."""
    from emox_torch.core.mesh import axis_group
    from emox_torch.ops.ring import ring_attention, ring_frame_attention, shard_seq

    group = axis_group(mesh, "context")
    out = {}
    for name, (fn, dim) in {"bhld": (ring_attention, 2), "frames": (ring_frame_attention, 1)}.items():
        for case, (q, k, v) in inputs["ring"][name].items():
            qs, ks, vs = (shard_seq(t, mesh, dim=dim).clone().requires_grad_(True) for t in (q, k, v))
            o = fn(qs, ks, vs, mesh)
            grads = torch.autograd.grad(o.square().sum(), (qs, ks, vs))
            out[f"{name}_{case}"] = {"out": _gather(o.detach(), group, dim),
                                     "grads": [_gather(g, group, dim) for g in grads]}
    return out


def check_temporal(inputs, mesh):
    """TemporalTransformer on this rank's frames with the ring (and, on a
    model axis, its heads sliced) against the same module on the whole clip
    without it."""
    from emox_torch.comm.sharding import apply_tensor_parallel
    from emox_torch.core.mesh import axis_group
    from emox_torch.nn.attention_blocks import TemporalTransformer
    from emox_torch.ops.ring import shard_seq

    x, state = inputs["temporal"]["x"], inputs["temporal"]["state"]
    plain = TemporalTransformer(16, 2, 8)
    plain.load_state_dict(state)
    ring = TemporalTransformer(16, 2, 8)
    ring.load_state_dict(state)
    apply_tensor_parallel(ring, mesh)
    ring.set_ring(mesh)
    with torch.no_grad():
        want = plain(x)
        got = ring(shard_seq(x, mesh, dim=1))
    return {"got": _gather(got, axis_group(mesh, "context"), 1), "want": want}


class RingCalls:
    """Counts the ring attention's launches of this rank (ops.ring._Ring)
    while it is entered."""

    def __enter__(self):
        from emox_torch.ops import ring

        self.count, self._apply = 0, ring._Ring.apply

        def counted(*args):
            self.count += 1
            return self._apply(*args)

        ring._Ring.apply = counted
        return self

    def __exit__(self, *exc):
        from emox_torch.ops import ring

        ring._Ring.apply = self._apply


def _trainer(case, mesh, name: str):
    import dataclasses

    from emox_torch.models.emo import EMOModel
    from emox_torch.train import Trainer

    cfg = case["cfg"]
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, checkpoint_dir=os.path.join(case["dir"], f"ckpt_{name}")))
    return Trainer(cfg, model=EMOModel(cfg, device="cpu").load_flax(case["params"]), mesh=mesh)


def check_step(case, mesh, name: str, keep_params: bool = True):
    """One step of case's stage through the Trainer on `mesh`: the metrics,
    the whole gradients, the ring's launches during the step, and the whole
    parameters after the update."""
    from emox_torch.comm.sharding import param_shardings

    tr = _trainer(case, mesh, name)
    plan = param_shardings(tr.model.modules, mesh)
    with RingCalls() as ring:
        metrics, grads = tr.loss_and_grads(case["batch"], case["draws"])
    names = tr.trainable_names()
    whole = [tr._whole(n, g).clone() for n, g in zip(names, grads)]  # the update clips grads in place
    if tr.state.optimizer.step(grads):
        tr._sync_modules()
    payload = tr._payload()
    tr.close()
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "names": names, "grads": whole,
           "ring_calls": ring.count}
    if keep_params:
        out.update(params=payload["params"], plan=plan)
    return out


def check_adafactor(inputs, mesh):
    """The port's Optimizer (adafactor) on this rank's slices of whole
    leaves split over `model` (inputs["adafactor"]: layouts, split dims,
    masters and each update's gradients): the whole masters after each
    update, and the whole optimizer state before the last (its moments
    gathered as a checkpoint gathers them)."""
    from emox_torch.comm.runtime import all_gather
    from emox_torch.core.mesh import MeshAxes, axis_group, axis_rank, axis_size
    from emox_torch.train import make_optimizer
    from emox_torch.train.trainer import ModelSplit

    ada = inputs["adafactor"]
    group, rank, size = axis_group(mesh, MeshAxes.MODEL), axis_rank(mesh, MeshAxes.MODEL), axis_size(mesh, MeshAxes.MODEL)
    split = ModelSplit(ada["split_dims"], group, size)
    local = lambda i, t: (t if split.dims[i] is None else t.chunk(size, dim=split.dims[i])[rank]).clone()
    whole = lambda i, t, dim=None: t.clone() if split.dims[i] is None else all_gather(
        t.contiguous(), group, dim=split.dims[i] if dim is None else dim)
    masters = [local(i, m) for i, m in enumerate(ada["masters"])]
    opt = make_optimizer(ada["cfg"], masters, ada["layouts"], split)
    steps, state = [], None
    for k, grads in enumerate(ada["grads"]):
        if k == len(ada["grads"]) - 1:
            state = opt.map_state(opt.state_dict(), whole)
        opt.step([local(i, g) for i, g in enumerate(grads)])
        steps.append([whole(i, m) for i, m in enumerate(masters)])
    return {"masters": steps, "state": state, "factored": [d is not None for d in opt.adafactor.dims]}


def check_adafactor_checkpoint(case, mesh):
    """Two adafactor steps of case's stage through the Trainer on `mesh`, a
    checkpoint written after the first: the whole masters after each."""
    tr = _trainer(case, mesh, "adafactor_tp")
    masters = []
    for step in range(2):
        tr.train_step_with_draws(case["batch"], case["draws"])
        masters.append({n: tr._whole(n, m).clone() for n, m in tr.state.masters.items()})
        if step == 0:
            tr._save(tr.ckpt, 1)
    tr.close()
    return {"masters": masters, "checkpoint_dir": tr.config.train.checkpoint_dir}


def check_windowed(inputs, mesh):
    """The windowed sampler with the windows split over `context`, at two
    fold sizes."""
    from emox_torch.infer import pipeline as tpipeline
    from emox_torch.infer.pipeline import EMOPipeline
    from emox_torch.models.emo import EMOModel

    w = inputs["windowed"]
    pipe = EMOPipeline(EMOModel(w["cfg"], device="cpu").load_flax(inputs["params"]), w["cfg"], mesh=mesh)
    out = {}
    for per_call in (1, tpipeline.WINDOWS_PER_CALL):
        tpipeline.WINDOWS_PER_CALL, before = per_call, tpipeline.WINDOWS_PER_CALL
        try:
            out[per_call] = pipe.generate_latents(**w["kwargs"])
        finally:
            tpipeline.WINDOWS_PER_CALL = before
    return out


def main(rank: int, world: int, directory: str) -> int:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(directory, 'store')}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    from emox_torch.core.config import MeshConfig
    from emox_torch.core.mesh import create_mesh

    inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    inputs["dir"] = directory
    results = {"meshes": check_meshes(inputs), "batch_names": check_batch_names(inputs)}
    mesh = lambda d, c, m: create_mesh(MeshConfig(data=d, context=c, model=m))
    ring_mesh = create_mesh(MeshConfig(data=1, context=4, model=1))
    results["ring"] = check_ring(inputs, ring_mesh)
    results["temporal"] = check_temporal(inputs, ring_mesh)
    results["temporal_tp"] = check_temporal(inputs, create_mesh(MeshConfig(data=1, context=2, model=2)))
    step = dict(inputs["step"], params=inputs["params"], dir=directory)
    for name, sizes in {"dp_cp": (2, 2, 1), "cp_tp": (1, 2, 2)}.items():
        results[f"step_{name}"] = check_step(step, mesh(*sizes), name)
    results["windowed"] = check_windowed(inputs, mesh(2, 2, 1))
    # the meshes the reference trains on that the runtime once refused; a
    # mesh of two ranks leaves ranks 2 and 3 outside it
    for name, (case, sizes) in inputs["legs"].items():
        m = mesh(*sizes)
        if m.get_coordinate() is not None:
            case = dict(inputs["cases"][case], params=inputs["params"], dir=directory)
            results[name] = check_step(case, m, name, keep_params=False)
    for name, sizes in {"adafactor_tp": (1, 1, 2), "adafactor_dp_tp": (2, 1, 2)}.items():
        m = mesh(*sizes)
        if m.get_coordinate() is not None:
            results[name] = check_adafactor(inputs, m)
    ckpt = dict(inputs["cases"]["adafactor"], params=inputs["params"], dir=directory)
    results["adafactor_checkpoint"] = check_adafactor_checkpoint(ckpt, mesh(2, 1, 2))
    if rank == 0:
        torch.save(results, os.path.join(directory, "results.tmp"))
        os.replace(os.path.join(directory, "results.tmp"), os.path.join(directory, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    try:
        code = main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
