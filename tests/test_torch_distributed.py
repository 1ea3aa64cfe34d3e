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
  * `python -m emox_torch train --coordinator ... --num-processes 2` on the
    CPU: both ranks exit 0 and print the same loss; only rank 0 writes.
"""

from __future__ import annotations

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
from emox_torch.train import Trainer
from tests.test_torch_bridge import model_params, no_kernel_launches, rel_err  # noqa: F401 (autouse fixture)
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
    torch.save({"mesh_configs": MESH_CASES, "batch_names": _batch_names_inputs(), "ring": _ring_inputs(), "temporal": _temporal_inputs(), "step": step,
                "params": params, "windowed": win}, d / "inputs.pt")
    started = time.monotonic()
    procs = _spawn(d)
    threads = torch.get_num_threads()
    try:
        # two of the reference's programs compile in processes of their own,
        # beside the third and the port's single-process runs here; while the
        # world runs, the file keeps to a few cores (the suite's other
        # workers share the machine)
        torch.set_num_threads(PARENT_THREADS)
        with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn"), initializer=_few_cores) as pool:
            jobs = {"reference_windowed": pool.submit(_reference_windowed), "reference_ring": pool.submit(_reference_rings)}
            refs = {"reference_step": _reference_loss_and_grads(2), "single_step": _single_step(step, params),
                    "single_windowed": _single_windowed(win, params)}
            refs.update({k: job.result() for k, job in jobs.items()})
    finally:
        torch.set_num_threads(threads)
        _join(procs, d, started)
    assert np.array_equal(np.asarray(refs["reference_step"][0]), np.asarray(jax.random.PRNGKey(REFERENCE_KEY)))
    return {"results": torch.load(d / "results.pt", weights_only=False), "params": params, **refs}


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


# ---- what a mesh cannot shard ------------------------------------------------------------------
def test_what_the_mesh_cannot_shard_raises(world):
    """Where the reference's GSPMD would replicate or reshard, the port's
    explicit collectives refuse: frames that do not divide by the context
    size (stage 1's single frame among them), stages 0 and 5 on more than
    one block, sparse-causal attention over a context axis, adafactor under
    tensor parallelism."""
    from emox_torch.core.mesh import BatchShard
    from emox_torch.diffusion.schedule import make_schedule
    from emox_torch.train import stage_loss_fn

    refused = world["results"]["refusals"]
    assert "context shard" in refused["sparse_causal_on_context"]
    assert "whole leaves" in refused["adafactor_under_tp"]
    _, params, tcfg = model_params("tiny")
    model = EMOModel(tcfg, device="cpu").load_flax(params)
    sched = make_schedule(tcfg.diffusion)
    for stage in (0, 5):
        with pytest.raises(NotImplementedError, match="one data x context block"):
            stage_loss_fn(model, tcfg, sched, stage, shard=BatchShard(0, 2))
    loss = stage_loss_fn(model, tcfg, sched, 1, shard=BatchShard(ctx_rank=1, ctx_size=2))
    batch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    with pytest.raises(ValueError, match="frame axis of 1 not divisible by 2"):
        loss(batch, {})


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
