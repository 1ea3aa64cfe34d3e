"""The port's distributed runtime on the CPU (gloo) against the reference's
on its CPU mesh, and against the port's own single-process results.

One module-scoped fixture writes the inputs and spawns a world of four
ranks (tests/torch_dist_worker.py; `file://` rendezvous, a 60 s timeout on
every collective, and a deadline past which the ranks are killed and the
fixture fails). While they run, the parent computes the references: the
reference's meshes, TP plan, ring attention and windowed sampler on JAX
CPU devices, its stage-2 loss and gradients (the stage-2 parity test's), and
the port's single-process step and sampler. Rank 0 saves what the world
computed; the tests compare:

  * mesh shapes, -1 absorption, the sub-mesh and the errors against
    emox.core.mesh.create_mesh (pure function on 8 devices, DeviceMesh on
    the 4-rank world), and axis_names naming the DeviceMesh's dims;
  * the batch-slicing names (batch_sharding, put_batch, shard_batch,
    with_context_sharding): each rank's block against the reference's
    shard on the device of the same mesh position;
  * the TP plan leaf for leaf against emox.comm.sharding.param_shardings;
  * ring_attention and ring_frame_attention, outputs and gradients, against
    emox.ops.ring on 4 devices at the reference tests' atol 2e-5 / 3e-5;
  * TemporalTransformer on the ring (and on the ring under TP) against the
    same module on the whole clip: the positional rows of each rank's frames;
  * the stage-2 step (motion frames, v-prediction, CFG dropout) at data 2 x
    context 2 and at context 2 x model 2 against the port's single-process
    step (loss <= 1e-5, gradients <= 1e-4 relative) and the reference's
    single-device loss and gradients, frozen leaves bit-identical after the
    update;
  * the windowed sampler with its windows over context 2, at two fold
    sizes, against the port's single-process latents and the reference's
    EMOPipeline at the dry run's bar (2e-3 x the latent scale);
  * the meshes the reference trains on that the runtime once refused, each
    against the port's single-process step (loss <= 1e-5, gradients <= 1e-4
    relative) and, where named, the reference's single-device loss and
    gradients: sparse-causal stage 2 (motion frames, reference dropout) at
    context 2, data 2 x context 2 and context 4 (one frame a rank), with
    the first and previous frames exchanged; stage 1 at data 2 x context 2
    and stage 2's two-frame clip at context 4, whose frames stay whole on
    every context rank (the dense temporal attention: no ring call); stage
    5 (`frames` split over context, and `images`) and stage 0 (a
    `landmarks_valid` mask that differs between ranks) across data x
    context, `iou` and `latent_std` formed from sums over the ranks;
    adafactor at model 2 and data 2 x model 2 against optax's update on the
    whole leaves and the port's one-process optimizer, on leaves whose
    shards would factor otherwise, and its state gathered and resumed in
    one process; a trainer's adafactor checkpoint written at data 2 x
    model 2 and resumed in one process;
  * `python -m emox_torch train --coordinator ... --num-processes 2` on the
    CPU: both ranks exit 0 and print the same loss; only rank 0 writes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import multiprocessing
import os
import re
import socket
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.comm import sharding as jsharding
from emox.comm.sharding import param_shardings as j_param_shardings
from emox.core import mesh as jmesh
from emox.core.config import MeshConfig as JMeshConfig
from emox.core.mesh import create_mesh as j_create_mesh
from emox.ops import ring as jring
from emox_torch.core.config import MeshConfig
from emox_torch.core.mesh import create_mesh, mesh_shape, single_device_mesh
from emox_torch.infer.pipeline import EMOPipeline
from emox_torch.interop.from_flax import SUBMODELS, _convert
from emox_torch.models.emo import EMOModel
from emox_torch.nn.attention_blocks import TemporalTransformer
from emox_torch.train import Trainer, make_optimizer
from tests import test_torch_stage0 as stage0
from tests import test_torch_stage5 as stage5
from tests.test_torch_bridge import IMAGE, model_params, no_kernel_launches, rel_err  # noqa: F401 (autouse fixture)
from tests.test_torch_train import _batch, _loss_configs, _port_leaves, _reference_draws, _reference_loss_and_grads
from tests.test_torch_windowed import GUIDANCE, STEPS, _t, inputs, reference_latents, windowed

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 240  # the whole world's run; a hung rank fails the fixture here
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
FWD_ATOL, GRAD_ATOL = 2e-5, 3e-5  # tests/test_ring.py's
FRAMES_W = 7  # the windowed request: 3 windows of 4 frames at most steps
PARENT_THREADS, REFERENCE_CORES = 2, 2  # the fixture's footprint beside the ranks' 2 threads each

MESH_CASES = {
    "dp_absorbs": MeshConfig(data=-1, context=2, model=1),
    "cp_tp": MeshConfig(data=1, context=2, model=2),
    "context_absorbs": MeshConfig(data=1, context=-1, model=1),
    "sub_mesh": MeshConfig(data=1, context=2, model=1),
    "named": MeshConfig(data=2, context=1, model=2, axis_names=("dp", "sp", "tp")),
    "two_free": MeshConfig(data=-1, context=-1, model=1),
    "indivisible": MeshConfig(data=-1, context=3, model=1),
    "too_big": MeshConfig(data=2, context=2, model=2),
}


def _j_mesh_config(cfg: MeshConfig) -> JMeshConfig:
    return JMeshConfig(data=cfg.data, context=cfg.context, model=cfg.model, axis_names=tuple(cfg.axis_names))


def _batch_names_inputs():
    """Host batches for put_batch (frame axis 1; a 1-D leaf keeps only rows),
    shard_batch (speeds of 5 frames stay whole on context 2; audio is no
    frame key) and with_context_sharding."""
    rng = np.random.default_rng(9)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"put_batch": {"frames": f(4, 6, 3), "ref": f(4, 2, 5), "ids": f(4)},
            "shard_batch": {"frames": f(4, 6, 3), "speeds": f(4, 5), "audio": f(4, 6, 2)},
            "with_context_sharding": {"x": f(2, 4, 3, 3)}}


def _ring_inputs():
    rng = np.random.default_rng(5)
    n = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return {"bhld": {"64_64": (n(2, 4, 64, 16), n(2, 4, 64, 16), n(2, 4, 64, 16)),
                     "64_128": (n(2, 4, 64, 16), n(2, 4, 128, 16), n(2, 4, 128, 16))},
            "frames": {"8": (n(2, 8, 6, 4, 8), n(2, 8, 6, 4, 8), n(2, 8, 6, 4, 8))}}


def _temporal_inputs():
    gen = torch.Generator().manual_seed(3)
    mod = TemporalTransformer(16, 2, 8)
    state = {k: 0.3 * torch.randn(v.shape, generator=gen) for k, v in mod.state_dict().items()}
    x = torch.randn((2, 8, 4, 4, 16), generator=gen)
    return {"x": x, "state": state}


REFERENCE_KEY = 102  # the key of the stage-2 parity test's reference loss (_reference_loss_and_grads)


def _step_inputs(tmp):
    jcfg, tcfg = _loss_configs(2)
    tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, checkpoint_dir=str(tmp / "ckpt_single")))
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    return {"cfg": tcfg, "batch": batch,
            "draws": _reference_draws(jcfg, 2, _batch(2), jax.random.PRNGKey(REFERENCE_KEY))}


def _sparse(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, use_sparse_causal=True))


def _train(cfg, **train):
    return cfg.replace(train=dataclasses.replace(cfg.train, **train))


def _cases(step):
    """The stages' inputs of the meshes the runtime once refused: {case:
    {cfg, batch, draws}}, each loss's draws the reference's own (replayed
    from its key, or its VAE's posterior draw)."""
    torch_batch = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    j1, t1 = _loss_configs(1)
    j2, t2 = _loss_configs(2)
    no_motion = {k: v for k, v in _batch(2).items() if k != "motion_frames"}
    _, t5 = stage5._configs()
    lat = IMAGE // t5.vae.downscale
    vae_eps = lambda n: torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(5),
                                                                     (n, lat, lat, t5.vae.latent_channels))))
    frames = stage5._batch("frames")
    return {
        "sc": dict(step, cfg=_sparse(step["cfg"])),
        "stage1": {"cfg": t1, "batch": torch_batch(_batch(1)),
                   "draws": _reference_draws(j1, 1, _batch(1), jax.random.PRNGKey(101))},
        "whole2": {"cfg": t2, "batch": torch_batch(no_motion),
                   "draws": _reference_draws(j2, 2, no_motion, jax.random.PRNGKey(7))},
        "stage5": {"cfg": t5, "batch": torch_batch(frames),
                   "draws": {"posterior_eps": vae_eps(frames["frames"].shape[0] * frames["frames"].shape[1])}},
        "stage5_images": {"cfg": t5, "batch": torch_batch(stage5._batch("images")), "draws": {"posterior_eps": vae_eps(2)}},
        "stage0": {"cfg": stage0._config()[1], "batch": torch_batch(stage0._batch("half")), "draws": {}},
        "adafactor": dict(step, cfg=_train(step["cfg"], optimizer="adafactor", learning_rate=0.05)),
    }


# the world's legs on those cases: {leg: (case, (data, context, model))}
LEGS = {
    "sc_cp": ("sc", (1, 2, 1)), "sc_dp_cp": ("sc", (2, 2, 1)), "sc_cp4": ("sc", (1, 4, 1)),
    "stage1_dp_cp": ("stage1", (2, 2, 1)), "whole_cp4": ("whole2", (1, 4, 1)),
    "stage5_dp_cp": ("stage5", (2, 2, 1)), "stage5_images_dp_cp": ("stage5_images", (2, 2, 1)),
    "stage0_dp": ("stage0", (4, 1, 1)), "stage0_dp_cp": ("stage0", (2, 2, 1)),
}
# adafactor's leaves under tensor parallelism: (flax shape, the port's flax
# axis of each of its axes, the port dim split over model 2)
TP_LEAVES = [
    ((160, 256), (1, 0), 0),  # column-parallel Dense [I, O]: whole, factored over (I, O); a shard's O is the smaller
    ((256, 200), (1, 0), 1),  # row-parallel: a shard's I falls below O, flipping the order too
    ((200, 250), (1, 0), 0),  # column-parallel: a shard's O (125) falls under 128; the whole leaf factors
    ((544, 136), (1, 0), 1),  # row-parallel along the largest dim either way: the row moment summed over model
    ((64, 48), (1, 0), 0),  # unfactored, its moment split
    ((200,), (0,), None),  # a replicated bias
]
ADA_UPDATES = 3


def _adafactor_inputs():
    """Whole masters (flax and port layouts), ADA_UPDATES gradients, and the
    configs of the reference's chain and the port's (adafactor, global-norm
    clipping 1.0, weight decay)."""
    rng = np.random.default_rng(21)
    jm, _, tcfg = model_params("tiny")
    train = dict(optimizer="adafactor", grad_clip_norm=1.0, learning_rate=0.05, weight_decay=0.01)
    jcfg, tcfg = _train(jm.config, **train), _train(tcfg, **train)
    port = lambda a, axes: torch.from_numpy(np.ascontiguousarray(np.transpose(a, axes)))
    flax = [rng.standard_normal(s).astype(np.float32) * 0.05 for s, _, _ in TP_LEAVES]
    grads = [[(rng.standard_normal(s) * 0.2).astype(np.float32) for s, _, _ in TP_LEAVES] for _ in range(ADA_UPDATES)]
    return jcfg, {"cfg": tcfg, "layouts": [ax for _, ax, _ in TP_LEAVES], "split_dims": [d for _, _, d in TP_LEAVES],
                  "flax": flax, "flax_grads": grads,
                  "masters": [port(a, ax) for a, (_, ax, _) in zip(flax, TP_LEAVES)],
                  "grads": [[port(g, ax) for g, (_, ax, _) in zip(gs, TP_LEAVES)] for gs in grads]}


def _windowed_inputs():
    _, params, tcfg = model_params("tiny")
    cfg = windowed(tcfg)
    req = inputs(cfg, FRAMES_W)
    kwargs = dict(ref_image=_t(req["image"]), wav=_t(req["wav"]), video_length=FRAMES_W, num_inference_steps=STEPS,
                  guidance_scale=GUIDANCE, speeds=_t(req["speeds"]), face_mask=_t(req["mask"]),
                  latents=_t(req["latents"]))
    return {"cfg": cfg, "kwargs": kwargs}, req


def _spawn(directory: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = []
    for rank in range(WORLD):
        log = open(directory / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"), str(rank),
                                        str(WORLD), str(directory)], cwd=ROOT, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def _join(procs, directory: Path, started: float):
    """Wait for every rank until the deadline; kill them all past it. Fails
    with the ranks' logs unless every rank exited 0."""
    for p, _ in procs:
        try:
            p.wait(timeout=max(1.0, DEADLINE_S - (time.monotonic() - started)))
        except subprocess.TimeoutExpired:
            break
    hung = [p for p, _ in procs if p.poll() is None]
    for p in hung:
        p.kill()
        p.wait()
    for _, log in procs:
        log.close()
    logs = "\n".join(f"--- rank {r} ---\n" + (directory / f"rank{r}.log").read_text()[-3000:] for r in range(WORLD))
    assert not hung, f"{len(hung)} rank(s) still running after {DEADLINE_S} s:\n{logs}"
    assert all(p.returncode == 0 for p, _ in procs), logs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("world")
    _, params, _ = model_params("tiny")
    win, req = _windowed_inputs()
    step = _step_inputs(d)
    cases = _cases(step)
    j_ada, ada = _adafactor_inputs()
    torch.save({"mesh_configs": MESH_CASES, "batch_names": _batch_names_inputs(), "ring": _ring_inputs(),
                "temporal": _temporal_inputs(), "step": step, "params": params, "windowed": win, "cases": cases,
                "legs": LEGS, "adafactor": ada}, d / "inputs.pt")
    started = time.monotonic()
    procs = _spawn(d)
    try:
        # two of the reference's programs compile in processes of their own,
        # beside the third and the port's single-process runs here; while the
        # world runs, the file keeps to a few cores (the suite's other
        # workers share the machine)
        with _parent_threads(), ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn"), initializer=_few_cores) as pool:
            jobs = {"reference_windowed": pool.submit(_reference_windowed), "reference_ring": pool.submit(_reference_rings),
                    "reference_sc": pool.submit(_reference_sparse_causal),
                    "reference_stage1": pool.submit(_reference_stage1)}
            refs = {"reference_step": _reference_loss_and_grads(2), "single_step": _single_step(step, params),
                    "single_windowed": _single_windowed(win, params),
                    "single": {name: _single(case, params, d / f"single_{name}") for name, case in cases.items()
                               if name != "adafactor"},
                    "reference_stage5": stage5._reference("frames"), "reference_stage0": stage0._reference("random", "half"),
                    "adafactor": _adafactor_references(j_ada, ada), "cases": cases}
            refs.update({k: job.result() for k, job in jobs.items()})
    finally:
        _join(procs, d, started)
    assert np.array_equal(np.asarray(refs["reference_step"][0]), np.asarray(jax.random.PRNGKey(REFERENCE_KEY)))
    return {"results": torch.load(d / "results.pt", weights_only=False), "params": params, "dir": d, **refs}


@contextlib.contextmanager
def _parent_threads():
    """torch on PARENT_THREADS threads here, the previous count restored
    after: the suite's other workers share the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(PARENT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _few_cores():
    """A reference process's initializer: run on REFERENCE_CORES of the
    cores this process may use (JAX sizes its pools before any program)."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, set(cores[-REFERENCE_CORES:]))


def _single_step(step, params):
    model = EMOModel(step["cfg"], device="cpu").load_flax(params)
    tr = Trainer(step["cfg"], model=model)
    metrics, grads = tr.loss_and_grads(step["batch"], step["draws"])
    if tr.state.optimizer.step(grads):
        tr._sync_modules()
    payload = tr._payload()
    tr.close()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "names": tr.trainable_names(), "grads": grads,
            "params": payload["params"]}


def _single(case, params, directory):
    """The port's one-process step of a case: metrics, trainable names and
    gradients."""
    cfg = _train(case["cfg"], checkpoint_dir=str(directory))
    tr = Trainer(cfg, model=EMOModel(cfg, device="cpu").load_flax(params))
    metrics, grads = tr.loss_and_grads(case["batch"], case["draws"])
    tr.close()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "names": tr.trainable_names(), "grads": grads}


def _reference_sparse_causal():
    """The reference's single-device sparse-causal stage-2 loss, metrics and
    gradients (in the port's leaves) on the stage-2 step's batch and key (run
    in a process of its own, which sets JAX up as the suite does)."""
    import tests.conftest  # noqa: F401 (the suite's JAX settings)
    from emox.diffusion import schedule as jschedule
    from emox.models.emo import EMOModel as JEMOModel
    from emox.train import stages as jstages

    _, params, _ = model_params("tiny")
    jcfg = _sparse(_loss_configs(2)[0])
    # remat changes no value, and compiles slower on the CPU
    jm = JEMOModel(jcfg.replace(model=dataclasses.replace(jcfg.model, remat=False)))
    loss_fn = jstages.stage_loss_fn(jm, jcfg, jschedule.make_schedule(jcfg.diffusion), 2)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in _batch(2).items()},
        jax.random.PRNGKey(REFERENCE_KEY))
    return float(loss), {k: float(v) for k, v in metrics.items()}, _port_leaves(grads)


def _reference_stage1():
    """The stage-1 parity test's reference loss, metrics and gradients (the
    port's leaves), key 101 (run in a process of its own)."""
    import tests.conftest  # noqa: F401 (the suite's JAX settings)

    key, loss, metrics, grads = _reference_loss_and_grads(1)
    assert np.array_equal(np.asarray(key), np.asarray(jax.random.PRNGKey(101)))
    return loss, metrics, _port_leaves(grads)


def _adafactor_references(jcfg, ada):
    """The masters after each update: the reference's optax chain on the
    flax leaves (in the port's layout) and the port's one-process
    optimizer on the whole leaves."""
    import optax
    from emox.train.trainer import make_optimizer as j_make_optimizer

    jopt = j_make_optimizer(jcfg)
    update = jax.jit(lambda g, st, p: (lambda u, s: (optax.apply_updates(p, u), s))(*jopt.update(g, st, p)))
    jparams = [jnp.asarray(a) for a in ada["flax"]]
    jstate = jopt.init(jparams)
    masters = [m.clone() for m in ada["masters"]]
    topt = make_optimizer(ada["cfg"], masters, ada["layouts"])
    port = lambda a, axes: np.ascontiguousarray(np.transpose(np.asarray(a), axes))
    optax_steps, single_steps = [], []
    for grads, flax_grads in zip(ada["grads"], ada["flax_grads"]):
        jparams, jstate = update([jnp.asarray(g) for g in flax_grads], jstate, jparams)
        topt.step([g.clone() for g in grads])
        optax_steps.append([port(p, ax) for p, ax in zip(jparams, ada["layouts"])])
        single_steps.append([m.clone() for m in masters])
    return {"optax": optax_steps, "single": single_steps, "factored": [d is not None for d in topt.adafactor.dims]}


def _reference_windowed():
    """The reference EMOPipeline's latents for the windowed request (run in
    a process of its own, which sets JAX up as the suite does)."""
    import tests.conftest  # noqa: F401 (the suite's JAX settings)

    jm, params, _ = model_params("tiny")
    _, req = _windowed_inputs()
    return reference_latents(windowed(jm.config), params, req, FRAMES_W)


def _single_windowed(win, params):
    return EMOPipeline(EMOModel(win["cfg"], device="cpu").load_flax(params), win["cfg"]).generate_latents(
        **win["kwargs"])


# ---- meshes ---------------------------------------------------------------------------
@pytest.mark.parametrize("sizes", [(-1, 1, 1), (-1, 2, 1), (-1, 2, 2), (2, 2, 2), (1, -1, 1), (1, 2, -1), (2, 1, 1),
                                   (-1, -1, 1), (-1, 3, 1), (4, 4, 1)])
def test_mesh_shape_matches_the_reference_on_eight_devices(sizes):
    cfg = MeshConfig(*sizes)
    try:
        want = j_create_mesh(_j_mesh_config(cfg), jax.devices()[:8])
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            mesh_shape(cfg, 8)
        return
    got, used = mesh_shape(cfg, 8)
    assert got == tuple(want.shape[a] for a in want.axis_names) and used == want.devices.size


def test_a_process_without_a_process_group_is_a_mesh_of_one():
    assert create_mesh(MeshConfig(data=-1)) is None and single_device_mesh() is None
    with pytest.raises(ValueError, match="needs 2 devices"):
        create_mesh(MeshConfig(data=2, context=1, model=1))


@pytest.mark.parametrize("case", sorted(MESH_CASES) + ["local_mesh"])
def test_meshes_over_the_world_match_the_reference(world, case):
    got = world["results"]["meshes"][case]
    # local_mesh(context=2) is the reference's create_mesh(data=-1, context=2, model=1) over every device
    cfg = MESH_CASES.get(case, MeshConfig(data=-1, context=2, model=1))
    try:
        want = j_create_mesh(_j_mesh_config(cfg), jax.devices()[:WORLD])
    except ValueError as e:
        assert got == {"error": str(e)}
        return
    assert got["names"] == tuple(cfg.axis_names) == tuple(want.axis_names)
    assert np.array_equal(np.array(got["ranks"]), np.vectorize(lambda dev: dev.id)(want.devices))
    # rank 0 is the first rank of every mesh
    assert tuple(got["coord"]) == (0, 0, 0)


def _reference_blocks(name: str, arrays):
    """Per rank r, the reference's block on device r of `arrays` placed by
    `name` on its data 2 x context 2 mesh."""
    mesh = j_create_mesh(JMeshConfig(data=2, context=2, model=1), jax.devices()[:WORLD])
    if name == "put_batch":
        placed = jmesh.put_batch(arrays, mesh, frame_axis=1)
    elif name == "shard_batch":
        placed = jsharding.shard_batch(arrays, mesh)
    else:
        placed = {k: jax.jit(lambda x: jsharding.with_context_sharding(x, mesh))(v) for k, v in arrays.items()}
    return [{k: np.asarray(next(s.data for s in v.addressable_shards if s.device.id == r)) for k, v in placed.items()}
            for r in range(WORLD)]


@pytest.mark.parametrize("name", ["batch_sharding", "put_batch", "shard_batch", "with_context_sharding"])
def test_batch_names_take_the_references_blocks(world, name):
    got = world["results"]["batch_names"]
    if name == "batch_sharding":
        for (mesh_name, ndim, fa), spec in got["specs"].items():
            sizes = (2, 2, 1) if mesh_name == "dp_cp" else (4, 1, 1)
            mesh = j_create_mesh(JMeshConfig(*sizes), jax.devices()[:WORLD])
            assert spec == tuple(jmesh.batch_sharding(mesh, ndim, fa).spec), (mesh_name, ndim, fa)
        return
    want = _reference_blocks(name, _batch_names_inputs()[name])
    for r in range(WORLD):
        block = got["blocks"][r][name]
        assert block.keys() == want[r].keys()
        for k, v in block.items():
            assert np.array_equal(v.numpy(), want[r][k]), (name, r, k, tuple(v.shape), want[r][k].shape)


def test_tp_plan_matches_the_reference_leaf_for_leaf(world):
    got = world["results"]["step_cp_tp"]["plan"]
    jmesh = j_create_mesh(JMeshConfig(data=1, context=2, model=2), jax.devices()[:WORLD])
    want = {}
    sharded = 0
    for path, s in jax.tree_util.tree_leaves_with_path(j_param_shardings(world["params"], jmesh)):
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        if keys[0] not in SUBMODELS:
            continue
        leaf = world["params"]
        for k in keys:
            leaf = leaf[k]
        name, _ = _convert(keys[1:], np.asarray(leaf))
        spec = tuple(s.spec) + (None,) * (np.ndim(leaf) - len(s.spec))
        # a Dense kernel [in, out] is the port's weight [out, in]
        want[f"{keys[0]}.{name}"] = spec[::-1] if name.endswith(".weight") and np.ndim(leaf) == 2 else spec
        sharded += "model" in spec
    assert sharded > 0 and set(got) == set(want)
    assert {n: s for n, s in got.items() if s != want[n]} == {}


# ---- ring attention -------------------------------------------------------------------
def _reference_rings():
    """{case: (out, grads of sum(out^2))} of emox.ops.ring on 4 devices
    (run in a process of its own, which sets JAX up as the suite does)."""
    import tests.conftest  # noqa: F401 (the suite's JAX settings)

    mesh = j_create_mesh(JMeshConfig(data=1, context=WORLD, model=1), jax.devices()[:WORLD])
    out = {}
    for layout, cases in _ring_inputs().items():
        fn, dim = (jring.ring_attention, 2) if layout == "bhld" else (jring.ring_frame_attention, 1)
        for size, qkv in cases.items():
            args = [jring.shard_seq(jnp.asarray(t.numpy()), mesh, dim=dim) for t in qkv]
            o, vjp = jax.vjp(lambda *a: fn(*a, mesh), *args)
            out[f"{layout}_{size}"] = (np.asarray(o), [np.asarray(g) for g in vjp(2.0 * o)])
    return out


@pytest.mark.parametrize("case", ["bhld_64_64", "bhld_64_128", "frames_8"])
def test_ring_matches_the_reference(world, case):
    want, want_grads = world["reference_ring"][case]
    got = world["results"]["ring"][case]
    np.testing.assert_allclose(got["out"].numpy(), want, atol=FWD_ATOL)
    for g, w in zip(got["grads"], want_grads):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL)


@pytest.mark.parametrize("case", ["temporal", "temporal_tp"])
def test_temporal_transformer_on_the_ring_equals_the_whole_clip(world, case):
    got = world["results"][case]
    # each rank's frames take their own positional rows: pe[:t_local] would
    # give ranks past the first the wrong ones, far outside this bar
    np.testing.assert_allclose(got["got"].numpy(), got["want"].numpy(), atol=1e-5)


# ---- the stage-2 step on two meshes ---------------------------------------------------------
@pytest.mark.parametrize("case", ["dp_cp", "cp_tp"])
def test_stage2_step_matches_one_process_and_the_reference(world, case):
    got, single = world["results"][f"step_{case}"], world["single_step"]
    _, want_loss, want_metrics, want_grads = world["reference_step"]
    assert got["names"] == single["names"]
    for k, v in single["metrics"].items():
        assert abs(got["metrics"][k] - v) <= LOSS_TOL * abs(v), k
    for k in want_metrics:
        assert abs(got["metrics"][k] - want_metrics[k]) <= LOSS_TOL * abs(want_metrics[k]), k
    flat = torch.cat([g.reshape(-1) for g in got["grads"]]).double()
    flat_single = torch.cat([g.reshape(-1) for g in single["grads"]]).double()
    assert rel_err(flat, flat_single.numpy()) <= GRAD_TOL
    want = _port_leaves(want_grads)
    assert rel_err(flat, np.concatenate([want[n].reshape(-1) for n in got["names"]])) <= GRAD_TOL
    assert abs(got["metrics"]["grad_norm"] - single["metrics"]["grad_norm"]) <= 1e-3 * single["metrics"]["grad_norm"]
    # the checkpoint's leaves are whole; the frozen ones kept their bits
    trainable = set(got["names"])
    for n, p in single["params"].items():
        assert got["params"][n].shape == p.shape, n
        if n not in trainable:
            assert torch.equal(got["params"][n], p), n


# ---- the windowed sampler across context ranks ------------------------------------------------
def test_windowed_sampler_over_context_matches_one_process_and_the_reference(world):
    single = world["single_windowed"].numpy()
    ref = world["reference_windowed"]
    scale = float(np.abs(ref).max())
    for per_call, lat in world["results"]["windowed"].items():
        lat = lat.numpy()
        assert rel_err(lat, single) <= 1e-5, per_call  # the same windows, summed in another order
        assert float(np.abs(lat - ref).max()) < 2e-3 * scale, per_call


# ---- the meshes the reference trains on ---------------------------------------------------------
def _holds(got, single, want=None):
    """A leg's metrics and whole gradients against the port's one-process
    step and, with want = (loss, metrics, the port's leaves of its
    gradients), the reference's single device."""
    assert got["names"] == single["names"]
    assert set(got["metrics"]) == set(single["metrics"])
    for k, v in single["metrics"].items():
        assert abs(got["metrics"][k] - v) <= LOSS_TOL * max(abs(v), 1e-6), (k, got["metrics"][k], v)
    flat = torch.cat([g.reshape(-1) for g in got["grads"]]).double()
    assert float(flat.norm()) > 0
    assert rel_err(flat, torch.cat([g.reshape(-1) for g in single["grads"]]).double().numpy()) <= GRAD_TOL
    if want is not None:
        want_loss, want_metrics, want_grads = want
        assert abs(got["metrics"]["loss"] - want_loss) <= LOSS_TOL * abs(want_loss)
        for k, v in want_metrics.items():
            assert abs(got["metrics"][k] - v) <= LOSS_TOL * max(abs(v), 1e-6), (k, got["metrics"][k], v)
        assert rel_err(flat, np.concatenate([np.asarray(want_grads[n]).reshape(-1) for n in got["names"]])) <= GRAD_TOL


@pytest.mark.parametrize("leg", ["sc_cp", "sc_dp_cp", "sc_cp4"])
def test_sparse_causal_step_over_context_matches_one_process_and_the_reference(world, leg):
    """Each rank's first and previous frames come from the other context
    ranks (at context 4 a rank holds one frame, and rank 0 holds only motion
    frames at context 2); the reference is dropped on one row, so every
    site runs both branches."""
    got = world["results"][leg]
    assert world["cases"]["sc"]["draws"]["ref_drop"].tolist() == [True, False]
    assert got["ring_calls"] > 0
    _holds(got, world["single"]["sc"], world["reference_sc"])


@pytest.mark.parametrize("leg", ["stage1_dp_cp", "whole_cp4"])
def test_whole_clips_on_every_context_rank_match_one_process(world, leg):
    """Frames that do not divide by the context size stay whole on every
    context rank (stage 1's one frame; stage 2's clip of two frames at
    context 4, through the dense temporal attention): no ring call, and
    each rank's share counted once over the context ranks. Stage 1 is also
    held to the reference's stage-1 loss and gradients."""
    got = world["results"][leg]
    assert got["ring_calls"] == 0
    if leg == "stage1_dp_cp":
        _holds(got, world["single"]["stage1"], world["reference_stage1"])
    else:
        _holds(got, world["single"]["whole2"])


@pytest.mark.parametrize("leg", ["stage5_dp_cp", "stage5_images_dp_cp"])
def test_stage5_across_data_and_context_matches_one_process_and_the_reference(world, leg):
    """`frames` split over context 2 and rows over data 2; `images` whole on
    both context ranks. latent_std is formed from the posterior means' sums
    over the ranks."""
    got = world["results"][leg]
    if leg == "stage5_images_dp_cp":
        _holds(got, world["single"]["stage5_images"])
        return
    eps, loss, metrics, grads = world["reference_stage5"]
    assert np.array_equal(eps, world["cases"]["stage5"]["draws"]["posterior_eps"].numpy())
    assert "latent_std" in got["metrics"] and not any("/" in k for k in got["metrics"])
    _holds(got, world["single"]["stage5"], (loss, metrics, _port_leaves(grads)))


@pytest.mark.parametrize("leg", ["stage0_dp", "stage0_dp_cp"])
def test_stage0_across_data_and_context_matches_the_reference(world, leg):
    """Four rows over data 4 (and two over data 2 x context 2), the second
    half of the batch without landmarks: each rank's landmark error divides
    by the whole batch's valid count, and iou is formed from the summed
    intersection and union."""
    got = world["results"][leg]
    loss, metrics, grads = world["reference_stage0"]
    assert {"iou", "landmark_mse", "landmark_frac"} <= set(got["metrics"])
    assert got["metrics"]["landmark_frac"] == 0.5
    _holds(got, world["single"]["stage0"], (loss, metrics, _port_leaves(grads)))


@pytest.mark.parametrize("leg", ["adafactor_tp", "adafactor_dp_tp"])
def test_adafactor_under_tensor_parallelism_matches_optax_and_one_process(world, leg):
    """Three updates of each rank's slices at model 2: the gathered masters
    against optax's chain on the whole flax leaves and the port's optimizer
    in one process. Every leaf is factored by its whole shape: the first
    four, whose shards would be factored over other dims or not at all."""
    got, ref = world["results"][leg], world["adafactor"]
    assert got["factored"] == ref["factored"] == [True, True, True, True, False, False]
    for k in range(ADA_UPDATES):
        for i, (m, single, want) in enumerate(zip(got["masters"][k], ref["single"][k], ref["optax"][k])):
            assert rel_err(m, single.numpy()) <= GRAD_TOL, (k, i)
            assert rel_err(m, want) <= GRAD_TOL, (k, i)


def test_adafactor_state_gathered_at_model_2_resumes_in_one_process(world):
    """The optimizer's state before its last update at model 2, every
    moment gathered to the whole leaf's (the factored moments that span the
    split dim whole on every rank), loaded into a one-process optimizer
    with the masters of that point: its update is the world's last."""
    got, ada = world["results"]["adafactor_tp"], _adafactor_inputs()[1]
    masters = [m.clone() for m in got["masters"][-2]]
    opt = make_optimizer(ada["cfg"], masters, ada["layouts"])
    opt.load_state_dict(got["state"])
    assert opt.count == ADA_UPDATES - 1
    with _parent_threads():
        opt.step([g.clone() for g in ada["grads"][-1]])
    for i, (m, want) in enumerate(zip(masters, got["masters"][-1])):
        assert rel_err(m, want.numpy()) <= LOSS_TOL, i


def test_adafactor_checkpoint_written_at_model_2_resumes_in_one_process(world):
    """Stage 2 with adafactor at data 2 x model 2: the gathered masters
    after each of two steps against one process's, and the checkpoint the
    world wrote after the first, resumed in one process, takes the world's
    second step."""
    got, case = world["results"]["adafactor_checkpoint"], world["cases"]["adafactor"]
    model = lambda cfg: EMOModel(cfg, device="cpu").load_flax(world["params"])
    with _parent_threads():
        cfg = _train(case["cfg"], checkpoint_dir=str(world["dir"] / "single_adafactor"))
        tr = Trainer(cfg, model=model(cfg))
        for k in range(2):
            tr.train_step_with_draws(case["batch"], case["draws"])
            for n, m in tr.state.masters.items():
                assert rel_err(got["masters"][k][n], m.numpy()) <= GRAD_TOL, (k, n)
        tr.close()
        cfg = _train(case["cfg"], checkpoint_dir=got["checkpoint_dir"], resume=True)
        tr = Trainer(cfg, model=model(cfg))
        assert tr.resume() == 1 and tr.state.optimizer.count == 1
        tr.train_step_with_draws(case["batch"], case["draws"])
        for n, m in tr.state.masters.items():
            assert rel_err(got["masters"][1][n], m.numpy()) <= LOSS_TOL, n
        tr.close()


# ---- the command line on two processes --------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_train_command_on_two_processes(tmp_path):
    from emox_torch import cli
    from emox_torch.core import config as tconfig
    from emox_torch.core.presets import tiny_config
    from emox_torch.data.fixtures import write_fixture_dataset

    meta = write_fixture_dataset(str(tmp_path / "clips"), num_clips=2, num_frames=8, size=32)
    assert cli.main(["precompute", "--metadata", meta, "--videos", str(tmp_path / "clips"), "--cache",
                     str(tmp_path / "cache"), "--device", "cpu"]) == 0
    assert cli.main(["pack-records", "--cache", str(tmp_path / "cache"), "--out", str(tmp_path / "records")]) == 0
    cfg = tiny_config(32, 2)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, cache_dir=str(tmp_path / "records"), batch_size=2),
                      train=dataclasses.replace(cfg.train, stage=2, num_steps=1, checkpoint_every=1, log_every=1,
                                                checkpoint_dir=str(tmp_path / "ckpt"), compute_dtype="float32"))
    tconfig.save_config(cfg, str(tmp_path / "tiny.yaml"))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-m", "emox_torch", "train", "--config", str(tmp_path / "tiny.yaml"),
                               "--device", "cpu", "--coordinator", f"localhost:{port}", "--num-processes", "2",
                               "--process-id", str(r)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "process 0/2" in outs[0][0] and "process 1/2" in outs[1][0]
    finals = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert finals[0]["final_step"] == finals[1]["final_step"] == 1
    assert finals[0]["loss"] == finals[1]["loss"] and np.isfinite(finals[0]["loss"])
    # rank 0 alone wrote: one checkpoint, one metrics file
    assert sorted(os.listdir(tmp_path / "ckpt" / "stage2")) == ["step_1.pt"]
    assert len(open(tmp_path / "ckpt" / "stage2_metrics.jsonl").read().splitlines()) == 2
