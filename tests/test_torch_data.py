"""The port's data pipeline (emox_torch.data, train_face_nets) against the
reference's (emox.data, emox.train.face_nets) on the same numpy inputs.

The reference takes its C library (native/libemoxhost.so) where it is
loaded, and that library rounds differently; these tests hold the port to
the reference's numpy branch exactly by patching the reference's `_lib` to
return None (test-side only), and, where the library is already loaded in
this process, to the library too within 1e-6. Nothing here builds it.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from emox.data import augment as jaugment
from emox.data import dataset as jdataset
from emox.data import face as jface
from emox.data import fixtures as jfixtures
from emox.data import native as jnative
from emox.data import precompute as jprecompute
from emox.data import records as jrecords
from emox_torch.core.config import AugmentConfig
from emox_torch.data import augment, dataset, face, fixtures, native, precompute, records
from emox_torch.data.dataset import STAGES

needs_cv2 = pytest.mark.skipif(jface.cv2 is None, reason="pose recovery needs cv2")


@pytest.fixture
def numpy_reference(monkeypatch):
    """The reference's data functions on their numpy branch."""
    monkeypatch.setenv("EMOX_NATIVE_NO_BUILD", "1")
    monkeypatch.setattr(jnative, "_lib", lambda: None)


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---- native ---------------------------------------------------------------------
def _native_cases():
    r = _rng(1)
    wav = r.normal(0, 0.3, 3001).astype(np.float32)
    img = r.uniform(-1, 1, (37, 29, 3)).astype(np.float32)
    u8 = r.integers(0, 256, (17, 13, 3), dtype=np.uint8)
    return {
        "resample_linear": [(wav, 44100.0, 16000.0), (wav, 16000.0, 22050.0)],
        "wav_window": [(wav, -50, 400), (wav, 2900, 300), (wav, 5000, 10), (wav, 10, 100)],
        "u8_to_unit": [(u8,)],
        "unit_to_u8": [(img * 1.1,)],
        "resize_bilinear": [(img, 64, 48), (img, 16, 9), (img, 37, 29)],
        "rms_envelope": [(wav, 640.0, 5), (wav, 333.3, 11)],
    }


@pytest.mark.parametrize("name", sorted(_native_cases()))
def test_native_copies_match_the_reference_numpy_branch(name, monkeypatch):
    cases = _native_cases()[name]
    lib = jnative._LIB  # loaded by an earlier test of this process, or None: never loaded here
    for args in cases:
        port = getattr(native, name)(*args)
        with monkeypatch.context() as m:
            m.setattr(jnative, "_lib", lambda: None)
            ref = getattr(jnative, name)(*args)
        assert port.dtype == ref.dtype and port.shape == ref.shape
        np.testing.assert_array_equal(port, ref)
        if lib is not None:
            np.testing.assert_allclose(port.astype(np.float32), getattr(jnative, name)(*args).astype(np.float32),
                                       atol=1e-6 if port.dtype != np.uint8 else 1)


@pytest.mark.parametrize("crop", [(3, 4, 30, 22, True), (0, 0, 37, 29, False), (5, 2, 20, 25, True)])
def test_augment_frame_matches_the_reference_numpy_path(crop, numpy_reference):
    img = _rng(2).uniform(-1, 1, (37, 29, 3)).astype(np.float32)
    y0, x0, ch, cw, flip = crop
    p = jaugment.AugmentParams(flip=flip, y0=y0, x0=x0, crop_h=ch, crop_w=cw, brightness=0.07, contrast=1.05)
    q = augment.AugmentParams(**vars(p))
    for color in (True, False):
        np.testing.assert_array_equal(augment.augment_frame(img, q, 32, 24, color),
                                      jaugment.augment_frame(img, p, 32, 24, color))
    np.testing.assert_array_equal(native.augment_frame(img, y0, x0, ch, cw, flip, 0.07, 1.05, 32, 24),
                                  jaugment.augment_frame(img, p, 32, 24, True))


# ---- face ---------------------------------------------------------------------------
def test_masks_and_renders_match_the_reference():
    r = _rng(3)
    for h, w in ((64, 64), (37, 50)):
        np.testing.assert_array_equal(face.geometric_prior_mask(h, w), jface.geometric_prior_mask(h, w))
        np.testing.assert_array_equal(face.mask_from_bbox(h, w, (5, 7, 30, 33), 0.2),
                                      jface.mask_from_bbox(h, w, (5, 7, 30, 33), 0.2))
        prob = r.uniform(0, 1, (h, w, 1)).astype(np.float32) ** 4
        np.testing.assert_array_equal(face.mask_from_probability(prob), jface.mask_from_probability(prob))
        empty = np.zeros((h, w, 1), np.float32)
        np.testing.assert_array_equal(face.mask_from_probability(empty), jface.mask_from_probability(empty))
    lm = r.uniform(0.2, 0.8, (3, 6, 2)).astype(np.float32)
    np.testing.assert_array_equal(face.render_landmark_skeleton(lm, 40, 48), jface.render_landmark_skeleton(lm, 40, 48))
    frame = r.uniform(-1, 1, (48, 40, 3)).astype(np.float32)
    pose = np.array([10.0, -20.0, 5.0], np.float32)
    np.testing.assert_array_equal(face.draw_pose_axes(frame, pose, (0.5, 0.4)),
                                  jface.draw_pose_axes(frame, pose, (0.5, 0.4)))
    np.testing.assert_array_equal(face.camera_matrix(40, 48), jface.camera_matrix(40, 48))


@needs_cv2
def test_pose_series_and_overlay_match_the_reference():
    clip = jfixtures.make_synthetic_clip(seed=4, num_frames=6, height=48, width=48)
    lm = clip["landmarks"]
    px = np.stack([lm[..., 1] * 48, lm[..., 0] * 48], axis=-1)
    poses = [face.head_pose_from_landmarks(p, 48, 48) for p in px]
    ref = [jface.head_pose_from_landmarks(p, 48, 48) for p in px]
    np.testing.assert_allclose(np.stack(poses), np.stack(ref), atol=1e-6)
    np.testing.assert_allclose(face.pose_velocities(np.stack(poses)), jface.pose_velocities(np.stack(ref)), atol=1e-6)
    np.testing.assert_allclose(face.pose_velocities_3d(np.stack(poses)), jface.pose_velocities_3d(np.stack(ref)),
                               atol=1e-6)
    np.testing.assert_array_equal(face.pose_debug_overlay(clip["frames"], lm, 2),
                                  jface.pose_debug_overlay(clip["frames"], lm, 2))
    helper_lm = np.stack([px[0]] * 4)
    np.testing.assert_allclose(face.FaceHelper(landmark_fn=lambda f: helper_lm[0]).pose_speed_series(clip["frames"][:4]),
                               jface.FaceHelper(landmark_fn=lambda f: helper_lm[0]).pose_speed_series(clip["frames"][:4]),
                               atol=1e-6)


# ---- augment ------------------------------------------------------------------------
@pytest.mark.parametrize("enabled", [True, False])
def test_augment_clip_matches_the_reference(enabled, numpy_reference):
    r = _rng(5)
    frames = r.uniform(-1, 1, (3, 40, 36, 3)).astype(np.float32)
    masks = (r.uniform(0, 1, (3, 40, 36, 1)) > 0.5).astype(np.float32)
    pts = r.uniform(0, 1, (3, 6, 2)).astype(np.float32)
    maps = r.uniform(0, 1, (3, 40, 36, 3)).astype(np.float32)
    cfg = AugmentConfig(enabled=enabled, crop_scale_min=0.6)
    jcfg = jaugment.AugmentConfig(**vars(cfg))
    for seed in range(4):
        port = augment.augment_clip(frames, masks, cfg, _rng(seed), points=pts, extra_maps=maps)
        ref = jaugment.augment_clip(frames, masks, jcfg, _rng(seed), points=pts, extra_maps=maps)
        assert len(port) == len(ref) == 4
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a, b)


# ---- fixtures and records ---------------------------------------------------------------
def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_fixture_dataset_is_the_reference_s(tmp_path):
    port = fixtures.write_fixture_dataset(str(tmp_path / "port"), num_clips=2, seed=3, num_frames=5, size=32)
    ref = jfixtures.write_fixture_dataset(str(tmp_path / "ref"), num_clips=2, seed=3, num_frames=5, size=32)
    assert open(port).read() == open(ref).read()
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        if n.endswith(".npz"):
            a, b = _npz(tmp_path / "port" / n), _npz(tmp_path / "ref" / n)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    r1, r2 = _rng(9), _rng(9)
    pb, jb = fixtures.synthetic_face_batch(r1, 3, 40, 40), jfixtures.synthetic_face_batch(r2, 3, 40, 40)
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_records_read_the_same_in_either_package(tmp_path, writer):
    fixtures.write_fixture_dataset(str(tmp_path / "clips"), num_clips=3, num_frames=4, size=16)
    write = records.write_shards if writer == "port" else jrecords.write_shards
    idx = write(str(tmp_path / "clips"), str(tmp_path / "rec"), shard_bytes=40_000)
    other = (jrecords.write_shards if writer == "port" else records.write_shards)(
        str(tmp_path / "clips"), str(tmp_path / "rec2"), shard_bytes=40_000)
    assert open(idx).read() == open(other).read()  # the same index, shard for shard
    for name in json.load(open(idx))["shards"]:
        assert (tmp_path / "rec" / name).read_bytes() == (tmp_path / "rec2" / name).read_bytes()
    assert records.is_sharded(str(tmp_path / "rec")) and jrecords.is_sharded(str(tmp_path / "rec"))
    port, ref = records.ShardedClipStore(str(tmp_path / "rec")), jrecords.ShardedClipStore(str(tmp_path / "rec"))
    assert port.clip_ids == ref.clip_ids
    for cid in ref.clip_ids:
        assert sorted(port.keys(cid)) == sorted(ref.keys(cid))
        assert port.num_frames(cid) == ref.num_frames(cid)
        for key in ref.keys(cid):
            np.testing.assert_array_equal(port.get(cid, key), ref.get(cid, key))
        np.testing.assert_array_equal(port.get(cid, "frames", [3, 0]), ref.get(cid, "frames", [3, 0]))


# ---- precompute ---------------------------------------------------------------------------
def _landmark_export(clip_path: str, size: int) -> None:
    """A <clip>.landmarks.npy export ([T, 6, 2] pixel (x, y)) beside a clip."""
    lm = _npz(clip_path)["landmarks"]
    np.save(clip_path[:-4] + ".landmarks.npy", np.stack([lm[..., 1] * size, lm[..., 0] * size], axis=-1))


def test_precompute_clip_matches_the_reference(tmp_path, numpy_reference):
    fixtures.write_fixture_dataset(str(tmp_path / "clips"), num_clips=1, seed=2, num_frames=6, size=32)
    src = str(tmp_path / "clips" / "synthetic_000.npz")
    _landmark_export(src, 32)
    port = precompute.precompute_clip(src, str(tmp_path / "port.npz"), device="cpu")
    ref = jprecompute.precompute_clip(src, str(tmp_path / "ref.npz"))
    a, b = _npz(tmp_path / "port.npz"), _npz(tmp_path / "ref.npz")
    assert a.keys() == b.keys() == port.keys() == ref.keys()
    assert {"frames", "face_masks", "wav", "pose_speeds", "pose_vel3", "landmarks", "control"} <= set(a)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_precompute_dataset_resumes_like_the_reference(tmp_path):
    meta = fixtures.write_fixture_dataset(str(tmp_path / "clips"), num_clips=2, num_frames=4, size=16)
    for i in range(2):
        _landmark_export(str(tmp_path / "clips" / f"synthetic_{i:03d}.npz"), 16)
    man = precompute.precompute_dataset(meta, str(tmp_path / "clips"), str(tmp_path / "cache"), device="cpu")
    first = json.load(open(man))
    stamp = os.path.getmtime(first["synthetic_000"]["path"])
    again = json.load(open(precompute.precompute_dataset(meta, str(tmp_path / "clips"), str(tmp_path / "cache"),
                                                         device="cpu")))
    assert again == first and os.path.getmtime(first["synthetic_000"]["path"]) == stamp  # skipped, not redone
    assert first == {cid: {"frames": 4, "path": str(tmp_path / "cache" / f"{cid}.npz")}
                     for cid in ("synthetic_000", "synthetic_001")}


@needs_cv2
def test_bare_clip_through_the_trained_face_nets(tmp_path, numpy_reference):
    """A clip with frames and audio only: masks, landmarks and pose series
    from the shipped face nets, the port's on the CPU against the
    reference's."""
    from emox_torch.train.face_nets import SHIPPED_ASSET_PATH

    clip = jfixtures.make_synthetic_clip(seed=7, num_frames=8, height=64, width=64)
    src = str(tmp_path / "bare.npz")
    np.savez(src, frames=clip["frames"], wav=clip["wav"])
    helper = face.FaceHelper.from_asset(SHIPPED_ASSET_PATH, device="cpu")
    a = precompute.precompute_clip(src, str(tmp_path / "port.npz"), face_helper=helper, with_control=False)
    b = jprecompute.precompute_clip(src, str(tmp_path / "ref.npz"), with_control=False)
    assert a.keys() == b.keys()
    agree = (a["face_masks"] == b["face_masks"]).mean()
    assert agree >= 0.999, agree
    np.testing.assert_allclose(a["landmarks"], b["landmarks"], atol=1e-4)
    np.testing.assert_allclose(a["pose_speeds"], b["pose_speeds"], atol=1e-4)
    np.testing.assert_allclose(a["pose_vel3"], b["pose_vel3"], atol=1e-4)
    assert np.abs(a["pose_speeds"]).max() > 0


# ---- dataset and loader -----------------------------------------------------------------
@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """Precomputed caches of three 10-frame clips at 32^2 (landmarks from an
    export, so every key is there), one without landmarks or control, and
    the same caches packed into shards."""
    root = tmp_path_factory.mktemp("caches")
    meta = jfixtures.write_fixture_dataset(str(root / "clips"), num_clips=3, seed=1, num_frames=10, size=32)
    for i in range(3):
        _landmark_export(str(root / "clips" / f"synthetic_{i:03d}.npz"), 32)
    lib = jnative._lib
    jnative._lib = lambda: None
    try:
        jprecompute.precompute_dataset(meta, str(root / "clips"), str(root / "cache"))
    finally:
        jnative._lib = lib
    bare = _npz(root / "cache" / "synthetic_002.npz")
    np.savez(root / "cache" / "synthetic_002.npz", **{k: v for k, v in bare.items() if k not in ("landmarks", "control")})
    os.remove(root / "cache" / "manifest.json")
    jrecords.write_shards(str(root / "cache"), str(root / "records"))
    return {"npz": str(root / "cache"), "records": str(root / "records")}


def _same_batches(port, ref):
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


@pytest.mark.parametrize("store", ["npz", "records"])
@pytest.mark.parametrize("stage", STAGES)
def test_dataset_samples_are_the_reference_s(caches, store, stage, numpy_reference):
    kw = dict(num_frames=4, audio_context_frames=2, augment=AugmentConfig(crop_scale_min=0.7),
              num_motion_frames=2 if stage != "stage0-facelocator" else 0,
              ref_mode="first" if stage in ("stage2", "stage3") else "random")
    port = dataset.EMODataset(caches[store], stage, **kw)
    ref = jdataset.EMODataset(caches[store], stage, **{**kw, "augment": jaugment.AugmentConfig(crop_scale_min=0.7)})
    assert len(port) == len(ref) == 3
    rp, rr = _rng(11), _rng(11)
    for _ in range(6):
        _same_batches(port.sample(rp), ref.sample(rr))


@pytest.mark.parametrize("store", ["npz", "records"])
def test_loader_batches_are_the_reference_s(caches, store, numpy_reference):
    port = dataset.DataLoader(dataset.EMODataset(caches[store], "stage3", num_frames=3, speed_axes=3), 2, seed=4,
                              prefetch=0)
    ref = jdataset.DataLoader(jdataset.EMODataset(caches[store], "stage3", num_frames=3, speed_axes=3), 2, seed=4,
                              prefetch=0)
    for _, a, b in zip(range(3), port, ref):
        _same_batches(a, b)
    # the prefetch thread gives the same stream as the loop without it
    threaded = dataset.DataLoader(dataset.EMODataset(caches[store], "stage1", num_frames=1), 2, seed=4, prefetch=2)
    plain = dataset.DataLoader(dataset.EMODataset(caches[store], "stage1", num_frames=1), 2, seed=4, prefetch=0)
    for _, a, b in zip(range(3), threaded, plain):
        _same_batches(a, b)
    # several workers: each batch from its own worker's seeded stream
    many = iter(dataset.DataLoader(dataset.EMODataset(caches[store], "stage1", num_frames=1), 2, seed=4,
                                   prefetch=2, num_workers=2))
    assert all(next(many)["images"].shape == (2, 32, 32, 3) for _ in range(3))


def test_stage3_three_axis_speeds_need_pose_vel3(tmp_path):
    clip = jfixtures.make_synthetic_clip(seed=0, num_frames=6, height=16, width=16)
    np.savez(tmp_path / "c.npz", **{k: v for k, v in clip.items()})  # no pose_vel3
    ds = dataset.EMODataset(str(tmp_path), "stage3", num_frames=2, speed_axes=3)
    with pytest.raises(ValueError, match="pose_vel3"):
        ds.sample(_rng(0))
    with pytest.raises(ValueError, match="stage must be one of"):
        dataset.EMODataset(str(tmp_path), "stage9")


def test_lru_keeps_at_most_max_cached_clips(caches):
    ds = dataset.EMODataset(caches["npz"], "stage1", max_cached_clips=2)
    r = _rng(0)
    for _ in range(12):
        ds.sample(r)
    assert len(ds._cache) <= 2


# ---- the face nets' training ------------------------------------------------------------
def _grads_as_flax(module):
    tree = {}
    for name, p in module.named_parameters():
        *mods, leaf = name.split(".")
        g = p.grad.numpy()
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        if leaf == "weight":
            node["kernel"] = g.transpose(2, 3, 1, 0)
        else:
            node["bias"] = g
    return tree


def test_train_face_nets_step_matches_the_reference():
    import jax
    import jax.numpy as jnp

    from emox.train import face_nets as jface_nets
    from emox_torch.train.face_nets import build_face_nets, face_nets_loss, train_face_nets

    size, batch, seed = 32, 4, 3
    # the reference's initial params, drawn as its train_face_nets draws them
    locator, landmarker = jface_nets.build_modules()
    key = jax.random.PRNGKey(seed)
    dummy = jnp.zeros((1, size, size, 3))
    init = {"face_locator": locator.init(key, dummy)["params"],
            "landmarker": landmarker.init(jax.random.fold_in(key, 1), dummy)["params"]}
    init = jax.tree_util.tree_map(np.asarray, init)

    def ref_loss(params, images, masks, landmarks):  # the reference's loss_fn
        logits = locator.apply({"params": params["face_locator"]}, images)
        bce = jnp.mean(jnp.maximum(logits, 0) - logits * masks + jnp.log1p(jnp.exp(-jnp.abs(logits))))
        lm = landmarker.apply({"params": params["landmarker"]}, images)
        return bce + 10.0 * jnp.mean((lm.astype(jnp.float32) - landmarks) ** 2)

    b = jfixtures.synthetic_face_batch(_rng(seed), batch, size, size)
    ref_value, ref_grads = jax.value_and_grad(ref_loss)(init, b["image"], b["mask"], b["landmarks"])
    nets = build_face_nets(torch.device("cpu"), init=init)
    loss, _, _ = face_nets_loss(*nets, *(torch.from_numpy(b[k]) for k in ("image", "mask", "landmarks")))
    loss.backward()
    assert abs(loss.item() - float(ref_value)) <= 1e-5 * abs(float(ref_value))
    # relative L2 over each net's gradients (the landmark heatmaps' bias has
    # a zero gradient, a softmax over cells being blind to it: rounding only)
    for name, net in zip(("face_locator", "landmarker"), nets):
        got, want = _grads_as_flax(net), jax.tree_util.tree_map(np.asarray, ref_grads[name])
        pairs = [(got[mod][leaf], want[mod][leaf]) for mod in want for leaf in want[mod]]
        diff = np.sqrt(sum(np.sum((g.astype(np.float64) - w) ** 2) for g, w in pairs))
        norm = np.sqrt(sum(np.sum(w.astype(np.float64) ** 2) for _, w in pairs))
        assert diff <= 1e-4 * norm, (name, diff / norm)

    # train_face_nets's first logged loss: the same batch, the same init
    _, port_metrics = train_face_nets(steps=1, batch_size=batch, image_size=size, seed=seed, log_every=1,
                                      device="cpu", init=init)
    _, ref_metrics = jface_nets.train_face_nets(steps=1, batch_size=batch, image_size=size, seed=seed, log_every=1)
    assert abs(port_metrics["loss"] - ref_metrics["loss"]) <= 1e-5 * abs(ref_metrics["loss"])
    assert set(port_metrics) == set(ref_metrics)


def test_train_face_nets_writes_the_reference_format(tmp_path):
    from emox.train.face_nets import load_face_nets as jload
    from emox_torch.train.face_nets import build_face_nets, load_face_nets, save_face_nets, train_face_nets

    params, _ = train_face_nets(steps=2, batch_size=2, image_size=32, log_every=0, device="cpu")
    path = save_face_nets(params, str(tmp_path / "nets.npz"), dtype=np.float32)
    ref, port = jload(path), load_face_nets(path)
    assert jax_tree_equal(ref, port)
    # the file loads back into the port's nets exactly
    nets = build_face_nets(torch.device("cpu"), init=port)
    from emox_torch.train.face_nets import flax_tree

    assert jax_tree_equal(flax_tree(nets[0]), params["face_locator"])


def jax_tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(jax_tree_equal(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_from_model_provider_runs_the_model_s_nets():
    from emox_torch.core.presets import tiny_config
    from emox_torch.models.emo import EMOModel
    from emox_torch.train.face_nets import SHIPPED_ASSET_PATH, load_face_nets, load_face_nets_into

    model = EMOModel(tiny_config(), device="cpu")
    load_face_nets_into(model.modules, load_face_nets(SHIPPED_ASSET_PATH))
    a = face.FaceHelper.from_model(model)
    b = face.FaceHelper.from_asset(SHIPPED_ASSET_PATH, device="cpu")
    frame = jfixtures.make_synthetic_clip(seed=2, num_frames=1, height=64, width=64)["frames"][0]
    np.testing.assert_array_equal(a.face_mask(frame), b.face_mask(frame))
    np.testing.assert_allclose(a.landmark_fn(frame), b.landmark_fn(frame), atol=1e-5)
