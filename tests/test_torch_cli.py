"""The port's command line (emox_torch.cli, `python -m emox_torch`) and its
YAML reader (emox_torch.core.yamlio), held against the reference's
(emox.cli, PyYAML) where both exist, and run end to end on the tiny preset
on the CPU (--device cpu): fixtures -> precompute -> pack-records -> train
-> infer, and with the side models (ControlNet, CLIP vision, the identity
embedding) train --stage 4 -> infer --identity.

The reference's CLI draws its sampler noise from jax.random, which torch
cannot reproduce, so its pieces are compared here and the port's video is
held against a direct EMOPipeline call with the same weights and inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import hashlib
import io
import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from emox import cli as jcli
from emox.core import config as jconfig
from emox.data import native as jnative
from emox_torch import cli
from emox_torch.core import config as tconfig
from emox_torch.core import yamlio
from emox_torch.core.presets import tiny_config

ROOT = Path(__file__).resolve().parents[1]
SHIPPED_ASSET = ROOT / "emox" / "assets" / "face_nets.npz"


@pytest.fixture
def numpy_reference(monkeypatch):
    """The reference's data functions on their numpy branch (its C library
    rounds differently); nothing here loads or builds that library."""
    monkeypatch.setenv("EMOX_NATIVE_NO_BUILD", "1")
    monkeypatch.setattr(jnative, "_lib", lambda: None)


# ---- YAML -------------------------------------------------------------------------
@pytest.mark.parametrize("path", sorted(glob.glob(str(ROOT / "configs" / "*.yaml"))), ids=os.path.basename)
def test_shipped_configs_read_as_pyyaml_reads_them(path):
    with open(path) as f:
        assert yamlio.load(path) == yaml.safe_load(f)
    assert dataclasses.asdict(tconfig.load_config(path)) == dataclasses.asdict(jconfig.load_config(path))


_SCALARS = ["1e-3", "1.0e-4", "-2.5E+3", "5", "-3", "0", "1_000", ".5", "1.", "yes", "Off", "TRUE", "null", "~", "",
            "abc", "a b c", "data/cache", "foo:bar", "x#y", "-foo", "09", "[1, 2, 4, 4]", "[]", "[a, 'b c', [1.5]]",
            '"x y"', "'it''s'", '"tab\\there \\u00e9"', ".inf", "-.inf"]


@pytest.mark.parametrize("text", _SCALARS)
def test_scalars_are_typed_as_pyyaml_types_them(text):
    want, got = yaml.safe_load(text), yamlio.loads(text)
    assert got == want and type(got) is type(want)


_REFUSED = ["0x1f", "012", "1:20", "2002-12-14", "&a 1", "*a", "!!str 1", "|", "a: [1", "<<", "{a: 1}", "[1, ]",
            "a: 1\na: 2\n", "a:\n\tb: 1\n", "a: |\n  x\n", "a:\n  - b: 1\n", "a: x\n  y\n", "---\na: 1\n---\nb: 2\n",
            "a:\n  - [1]\n  -\n    - 2\n", "? a\n: 1\n"]


@pytest.mark.parametrize("text", _REFUSED)
def test_what_the_reader_does_not_read_raises_naming_the_line(text):
    with pytest.raises(ValueError, match=r"line \d+"):
        yamlio.loads(text)


def test_nested_blocks_and_comments():
    doc = ("# top\nmodel:   # the model\n  widths: [1, 2]  # flow\n  levels:\n  - 0\n  - 1 # one\n"
           "  name: 'a # b'\ntrain:\n    lr: 1.0e-5\n    tags:\n      - x\nempty:\n")
    assert yamlio.loads(doc) == yaml.safe_load(doc)


def test_save_config_round_trips_and_reads_the_reference_s(tmp_path):
    cfg = tiny_config().replace(train=dataclasses.replace(tconfig.TrainConfig(), checkpoint_dir="a b/#c: d",
                                                          learning_rate=1e-5, weight_decay=0.0))
    tconfig.save_config(cfg, str(tmp_path / "port.yaml"))
    assert tconfig.load_config(str(tmp_path / "port.yaml")) == cfg
    with open(tmp_path / "port.yaml") as f:
        assert yaml.safe_load(f) == yamlio.load(str(tmp_path / "port.yaml"))
    assert dataclasses.asdict(jconfig.load_config(str(tmp_path / "port.yaml"))) == dataclasses.asdict(cfg)
    jconfig.save_config(jconfig.Config(), str(tmp_path / "ref.yaml"))
    assert dataclasses.asdict(tconfig.load_config(str(tmp_path / "ref.yaml"))) == dataclasses.asdict(jconfig.Config())
    with pytest.raises(ValueError, match="ref.yaml: line"):
        (tmp_path / "ref.yaml").write_text("train:\n  lr: &x 1\n")
        tconfig.load_config(str(tmp_path / "ref.yaml"))


# ---- the CLI's helpers --------------------------------------------------------------
_OVERRIDES = [["train.learning_rate=1e-3"], ["train.learning_rate=1.0e-4", "train.resume=false"],
              ["model.attention_levels=[0, 1]"], ["train.resume=yes"], ["data.cache_dir=data/x y"],
              ["inference.guidance_scale=7"], ["train.checkpoint_dir="], ["model.resnet_temb_mode='add'"],
              ["a.b.c=1"], ["train.seed=-3"], ["x.y=null"], ["x.y=~"], ['x.y="quoted: yes"'], ["x.y=.5"],
              ["x.y=1e5", "x.z=inf"], ["bad"], ["nodot=1"]]


@pytest.mark.parametrize("pairs", _OVERRIDES, ids=lambda p: " ".join(p))
def test_parse_overrides_agrees_with_the_reference(pairs):
    try:
        want = jcli._parse_overrides(pairs)
    except SystemExit as e:
        with pytest.raises(SystemExit, match="section.key=value"):
            cli._parse_overrides(pairs)
        assert "section.key=value" in str(e)
        return
    assert cli._parse_overrides(pairs) == want


def _speed_cases(tmp_path):
    r = np.random.default_rng(0)
    files = {}
    for name, arr in (("t", r.uniform(-1, 1, 5)), ("t1", r.uniform(-1, 1, (5, 1))), ("t3", r.uniform(-1, 1, (9, 3))),
                      ("t2", r.uniform(-1, 1, (5, 2)))):
        files[name] = str(tmp_path / f"{name}.npy")
        np.save(files[name], arr.astype(np.float32))
    return [(None, 6, 1), ("0.1,0,0", 6, 3), ("0.5", 4, 1), (files["t"], 7, 1), (files["t"], 3, 3),
            (files["t1"], 6, 1), (files["t3"], 6, 3), (files["t3"], 12, 3), ("0.1,0.2", 4, 3), (files["t2"], 5, 3)]


def test_parse_speeds_agrees_with_the_reference(tmp_path):
    for spec, total, axes in _speed_cases(tmp_path):
        try:
            want = jcli._parse_speeds(spec, total, axes)
        except SystemExit:
            with pytest.raises(SystemExit):
                cli._parse_speeds(spec, total, axes)
            continue
        got = cli._parse_speeds(spec, total, axes)
        if want is None:
            assert got is None
            continue
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _write_wav(path, rate, channels, seconds=0.3, seed=0):
    pcm = np.random.default_rng(seed).normal(0, 0.2, (int(rate * seconds), channels)).clip(-1, 1)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes((pcm * 32767).astype(np.int16).tobytes())


def test_load_image_and_audio_agree_with_the_reference(tmp_path, numpy_reference):
    r = np.random.default_rng(1)
    images = {"f.npy": r.uniform(-1, 1, (32, 32, 3)).astype(np.float32),
              "u8.npy": r.integers(0, 256, (40, 28, 4), dtype=np.uint8)}
    for name, img in images.items():
        np.save(tmp_path / name, img)
    paths = [str(tmp_path / n) for n in images]
    try:
        import imageio.v3 as iio

        iio.imwrite(tmp_path / "img.png", r.integers(0, 256, (24, 30, 3), dtype=np.uint8))
        paths.append(str(tmp_path / "img.png"))
    except ImportError:
        pass
    for p in paths:
        got, want = cli._load_image(p, 32, 32), jcli._load_image(p, 32, 32)
        assert got.shape == want.shape == (32, 32, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    _write_wav(tmp_path / "mono16k.wav", 16000, 1)
    _write_wav(tmp_path / "stereo44k.wav", 44100, 2)
    np.save(tmp_path / "a.npy", r.normal(0, 0.1, 800).astype(np.float64))
    for name in ("mono16k.wav", "stereo44k.wav", "a.npy"):
        (got, sr), (want, want_sr) = cli._load_audio(str(tmp_path / name), 16000), jcli._load_audio(
            str(tmp_path / name), 16000)
        assert sr == want_sr == 16000 and got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_unreadable_image_names_both_readers(tmp_path):
    (tmp_path / "x.png").write_bytes(b"not an image")
    with pytest.raises(SystemExit, match="(?s)imageio .* cv2 .*npy"):
        cli._load_image(str(tmp_path / "x.png"), 8, 8)


# ---- refusals ------------------------------------------------------------------------
@pytest.mark.parametrize("argv, item", [
    (["bench", "--preset", "tiny"], "benchmark"),
    # multi-process training is ported: a coordinator without the other
    # two flags exits naming them
    (["train", "--stage", "2", "--coordinator", "h:1", "--device", "cpu"], "--num-processes and --process-id"),
], ids=["bench", "distributed"])
def test_unported_commands_exit_naming_their_item(argv, item):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code not in (0, None) and item in str(e.value.code)


def test_every_entry_point_needs_a_card_or_an_explicit_cpu(monkeypatch, tmp_path):
    from emox_torch.data.face import FaceHelper
    from emox_torch.data.precompute import precompute_clip
    from emox_torch.train.face_nets import train_face_nets

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.save(tmp_path / "r.npy", np.zeros((32, 32, 3), np.float32))
    for argv in (["precompute", "--metadata", "m.json", "--videos", "v", "--cache", str(tmp_path / "c")],
                 ["train", "--stage", "1", "--set", f"train.checkpoint_dir={tmp_path / 'ck'}"],
                 ["infer", "--ref-image", str(tmp_path / "r.npy"), "--audio", "a.wav"],
                 ["train-face", "--steps", "1", "--out", str(tmp_path / "f.npz")],
                 ["export", "--frames", "2", "--size", "32", "--out", str(tmp_path / "s.pt2")]):
        with pytest.raises(SystemExit, match="--device cpu"):
            cli.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FaceHelper.from_asset()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_face_nets(steps=1)
    np.savez(tmp_path / "bare.npz", frames=np.zeros((2, 16, 16, 3), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        precompute_clip(str(tmp_path / "bare.npz"), str(tmp_path / "out.npz"))
    assert not (tmp_path / "f.npz").exists() and not (tmp_path / "s.pt2").exists()


def test_reference_checkpoints_point_at_from_flax(tmp_path):
    (tmp_path / "orbax" / "500").mkdir(parents=True)
    with pytest.raises(SystemExit, match="from_flax"):
        cli._restore_params(str(tmp_path / "orbax"))
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli._restore_params(str(tmp_path / "missing"))


# ---- end to end on the tiny preset ---------------------------------------------------------
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Fixtures -> precompute -> pack-records -> train stage 0 and stage 2 on
    the tiny preset at 32^2 on the CPU; the paths and what each printed."""
    from emox_torch.data.fixtures import write_fixture_dataset

    d = tmp_path_factory.mktemp("cli")
    asset = hashlib.sha256(SHIPPED_ASSET.read_bytes()).hexdigest()
    out = {}

    def call(name, argv):
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(argv) == 0
        out[name] = buf.getvalue()

    meta = write_fixture_dataset(str(d / "clips"), num_clips=2, num_frames=8, size=32)
    call("precompute", ["precompute", "--metadata", meta, "--videos", str(d / "clips"), "--cache", str(d / "cache"),
                        "--debug-overlays", "--device", "cpu"])
    call("pack", ["pack-records", "--cache", str(d / "cache"), "--out", str(d / "records")])
    cfg = tiny_config(32, 2)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, cache_dir=str(d / "records"), batch_size=2),
                      train=dataclasses.replace(cfg.train, stage=2, num_steps=2, checkpoint_every=2, log_every=1,
                                                checkpoint_dir=str(d / "ckpt"), compute_dtype="float32"))
    tconfig.save_config(cfg, str(d / "tiny.yaml"))
    call("stage0", ["train", "--stage", "0", "--config", str(d / "tiny.yaml"), "--device", "cpu"])
    call("stage2", ["train", "--config", str(d / "tiny.yaml"), "--device", "cpu"])
    call("stage2_again", ["train", "--config", str(d / "tiny.yaml"), "--device", "cpu"])
    # stage 3 without motion frames: with them the per-frame speeds cover the
    # clip only, and the reference's loss fails as the port's does
    call("stage3", ["train", "--stage", "3", "--from-stage", "2", "--config", str(d / "tiny.yaml"),
                    "--set", "train.resume=false", "data.num_motion_frames=0", "--device", "cpu"])
    np.save(d / "ref.npy", np.random.default_rng(0).uniform(-1, 1, (32, 32, 3)).astype(np.float32))
    _write_wav(d / "speech.wav", 22050, 1, seconds=0.2, seed=3)
    return {"dir": d, "cfg": cfg, "out": out, "asset": asset}


def test_precompute_and_pack_write_caches_and_records(run):
    d = run["dir"]
    assert "precomputed 2 clips" in run["out"]["precompute"] and "packed 2 clips into 1 shard" in run["out"]["pack"]
    with np.load(d / "cache" / "synthetic_000.npz") as z:
        assert {"frames", "face_masks", "wav", "pose_speeds", "pose_vel3", "landmarks", "control"} <= set(z.files)
    assert os.path.exists(d / "records" / "index.json")
    assert any(f.endswith("_debug.png") or f.endswith("_debug.npy") for f in os.listdir(d / "cache"))


def test_train_stages_checkpoint_resume_and_chain(run):
    d, out = run["dir"], run["out"]
    for stage in (0, 2, 3):
        assert os.path.exists(d / "ckpt" / f"stage{stage}" / "step_2.pt"), stage
    assert tconfig.load_config(str(d / "ckpt" / "stage2_config.yaml")) == run["cfg"]
    assert '"final_step": 2' in out["stage0"] and '"iou"' in out["stage0"]
    assert "resumed at step 2" in out["stage2_again"]
    assert "initialised from stage-2 checkpoint" in out["stage3"]
    assert tconfig.load_config(str(d / "ckpt" / "stage3_config.yaml")).train.stage == 3


def _infer(run, name, *extra):
    d = run["dir"]
    argv = ["infer", "--config", str(d / "tiny.yaml"), "--params", str(d / "ckpt" / "stage2"), "--ref-image",
            str(d / "ref.npy"), "--audio", str(d / "speech.wav"), "--steps", "2", "--out", str(d / f"{name}.npz"),
            "--device", "cpu", *extra]
    assert cli.main(argv) == 0
    with np.load(d / f"{name}.npz") as z:
        return z["frames"]


def test_infer_is_a_direct_pipeline_call(run):
    from emox_torch.infer.pipeline import EMOPipeline
    from emox_torch.infer.video_io import frames_to_uint8
    from emox_torch.models.emo import EMOModel

    frames = _infer(run, "plain", "--frames", "2", "--face-mask", "auto", "--speeds", "0.3", "--guidance", "3.0")
    assert frames.shape == (2, 32, 32, 3) and frames.dtype == np.uint8
    model = EMOModel(run["cfg"], device="cpu")
    cli._load_weights(model, cli._restore_params(str(run["dir"] / "ckpt" / "stage2")))
    ref = torch.from_numpy(np.load(run["dir"] / "ref.npy"))[None]
    wav, _ = cli._load_audio(str(run["dir"] / "speech.wav"), 16000)
    mask = (torch.sigmoid(model.locate_face(ref)) > 0.5).float()
    if float(mask.mean()) < 0.01:
        from emox_torch.data.face import geometric_prior_mask

        mask = torch.from_numpy(geometric_prior_mask(32, 32)[None])
    video = EMOPipeline(model)(ref, torch.from_numpy(wav[None]), video_length=2, num_inference_steps=2,
                               guidance_scale=3.0, face_mask=mask, speeds=torch.full((1, 2), 0.3))
    np.testing.assert_array_equal(frames, frames_to_uint8(video[0].numpy()))


def test_infer_grid_tiles_as_the_reference(run):
    assert _infer(run, "grid", "--frames", "2", "--grid", "2").shape == (2, 36, 70, 3)


def test_infer_autoregressive_runs_generate_long(run):
    """generate_long, with the face mask read from an image file."""
    np.save(run["dir"] / "mask.npy", np.ones((32, 32, 1), np.float32))
    frames = _infer(run, "long", "--frames", "4", "--autoregressive", "--set", "inference.context_frames=3",
                    "--face-mask", str(run["dir"] / "mask.npy"))
    assert frames.shape == (4, 32, 32, 3)


def test_python_m_emox_torch_infer(run):
    d = run["dir"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m", "emox_torch", "infer", "--config", str(d / "tiny.yaml"), "--ref-image",
                          str(d / "ref.npy"), "--audio", str(d / "speech.wav"), "--frames", "2", "--steps", "1",
                          "--out", str(d / "sub.npz"), "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "random init" in res.stdout and "wrote" in res.stdout
    with np.load(d / "sub.npz") as z:
        assert z["frames"].shape == (2, 32, 32, 3)


# ---- the side models: train --stage 4, infer --identity -------------------------------------
@pytest.fixture(scope="module")
def side_run(run):
    """On the records of `run`, from a config written by save_config with
    the ControlNet, a 2-layer CLIP vision encoder and the identity
    embedding: train --stage 1 (1 step, which moves the zero-initialised
    identity projection), then train --stage 4 --from-stage 1 (3 steps, a
    checkpoint at step 3). No motion frames: the control renders cover the
    clip only, so the reference's stage-4 loss fails with them, as the
    port's does."""
    d = run["dir"]
    base = run["cfg"]
    cfg = base.replace(
        model=dataclasses.replace(base.model, use_controlnet=True, use_identity_embed=True),
        clip=dataclasses.replace(base.clip, vision_enabled=True, vision_hidden_dim=16, vision_layers=2,
                                 vision_heads=2, image_size=28, patch_size=14, projection_dim=8),
        data=dataclasses.replace(base.data, num_motion_frames=0),
        train=dataclasses.replace(base.train, stage=4, num_steps=3, checkpoint_every=3, learning_rate=1e-3,
                                  checkpoint_dir=str(d / "side_ckpt")))
    tconfig.save_config(cfg, str(d / "side.yaml"))
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["train", "--stage", "1", "--config", str(d / "side.yaml"), "--set", "train.num_steps=1",
                         "train.checkpoint_every=1", "--device", "cpu"]) == 0
        assert cli.main(["train", "--stage", "4", "--from-stage", "1", "--config", str(d / "side.yaml"),
                         "--device", "cpu"]) == 0
    return {"cfg": cfg, "out": buf.getvalue()}


def test_train_stage4_changes_the_controlnet_alone(run, side_run):
    """The stage-4 checkpoint against the stage-1 one it started from: every
    ControlNet zero conv moved, no leaf outside the ControlNet did."""
    d = run["dir"]
    assert os.path.exists(d / "side_ckpt" / "stage4" / "step_3.pt")
    assert "stage 4: ControlNet" in side_run["out"] and '"final_step": 3' in side_run["out"]
    assert "initialised from stage-1 checkpoint" in side_run["out"]
    start = cli._restore_params(str(d / "side_ckpt" / "stage1"))
    trained = cli._restore_params(str(d / "side_ckpt" / "stage4"))
    assert set(trained) == set(start)
    changed = {n for n in start if not torch.equal(trained[n], start[n])}
    assert changed and all(n.startswith("controlnet.") for n in changed)
    assert {n for n in start if n.startswith("controlnet.zero_conv")} <= changed
    assert bool(start["denoiser.identity_embed_proj.weight"].any())  # stage 1 trained it


def test_infer_identity_is_a_direct_pipeline_call(run, side_run):
    """infer --identity on the stage-4 checkpoint equals EMOPipeline(...,
    use_identity=True) on the restored weights, bit for bit."""
    from emox_torch.infer.pipeline import EMOPipeline
    from emox_torch.infer.video_io import frames_to_uint8
    from emox_torch.models.emo import EMOModel

    d = run["dir"]
    argv = ["infer", "--config", str(d / "side.yaml"), "--params", str(d / "side_ckpt" / "stage4"), "--ref-image",
            str(d / "ref.npy"), "--audio", str(d / "speech.wav"), "--frames", "2", "--steps", "2", "--identity",
            "--out", str(d / "identity.npz"), "--device", "cpu"]
    assert cli.main(argv) == 0
    with np.load(d / "identity.npz") as z:
        frames = z["frames"]
    model = EMOModel(side_run["cfg"], device="cpu")
    cli._load_weights(model, cli._restore_params(str(d / "side_ckpt" / "stage4")))
    ref = torch.from_numpy(np.load(d / "ref.npy"))[None]
    wav, _ = cli._load_audio(str(d / "speech.wav"), 16000)
    pipe = EMOPipeline(model)
    video = pipe(ref, torch.from_numpy(wav[None]), video_length=2, num_inference_steps=2, use_identity=True)
    assert frames.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(frames, frames_to_uint8(video[0].numpy()))
    plain = pipe(ref, torch.from_numpy(wav[None]), video_length=2, num_inference_steps=2)
    assert not torch.equal(plain, video)  # the identity embedding reached the frames (stage 1 trained it)


def test_train_face_writes_where_told_and_leaves_the_shipped_asset(run, tmp_path):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["train-face", "--steps", "2", "--batch-size", "2", "--size", "32", "--out",
                         str(tmp_path / "nets.npz"), "--device", "cpu"]) == 0
    from emox.train.face_nets import load_face_nets as load_reference

    assert set(load_reference(str(tmp_path / "nets.npz"))) == {"face_locator", "landmarker"}
    assert '"asset"' in buf.getvalue()
    assert hashlib.sha256(SHIPPED_ASSET.read_bytes()).hexdigest() == run["asset"]


# ---- export and import-weights -------------------------------------------------------------
def test_export_is_the_eager_step_of_the_checkpoint(run):
    """export --params on the CPU: the artifact, loaded, gives the eager
    step of the restored weights; the command prints the switches it fixed
    and the graph's kernel ops."""
    from emox_torch.infer.export import load_exported, step_inputs
    from emox_torch.models.emo import EMOModel

    d = run["dir"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["export", "--config", str(d / "tiny.yaml"), "--params", str(d / "ckpt" / "stage2"),
                         "--frames", "2", "--size", "32", "--out", str(d / "step.pt2"), "--device", "cpu"]) == 0
    info = json.loads(buf.getvalue().splitlines()[0])
    assert info["kernel_ops"] == {"ln_geglu_ff": info["kernel_ops"]["ln_geglu_ff"]} and info["bytes"] > 0
    assert info["switches"]["EMOX_ATTENTION_IMPL"] == "xla" and info["dtype"] == "float32"
    model = EMOModel(run["cfg"], device="cpu")
    cli._load_weights(model, cli._restore_params(str(d / "ckpt" / "stage2")))
    args = step_inputs(model, 2, 32, 1, torch.float32, torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model.predict_noise(args[0], args[1], args[2], audio_windows=args[3], speeds=args[4],
                                   face_mask=args[5])
    got = load_exported(str(d / "step.pt2"))(dict(model.modules.named_parameters()), *args)
    assert float((got - want).norm() / want.norm()) <= 1e-6


def test_import_weights_writes_the_ports_state_dicts(tmp_path):
    """import-weights on a float16 .safetensors VAE and a .pt UNet in the
    diffusers names: one torch.save state dict per component, the import's
    tensors, and each report's summary."""
    from emox_torch.core.config import Config, ModelConfig, VAEConfig
    from emox_torch.interop import torch_import as timport
    from tests.test_torch_interop import UNET2D, VAE, _tiny_unet, _tiny_vae, _write_safetensors

    vae_sd = {k: v.half() for k, v in _tiny_vae().state_dict().items()}
    _write_safetensors(tmp_path / "vae.safetensors", vae_sd, {torch.float16: "F16"})
    unet_sd = dict(_tiny_unet().state_dict())
    torch.save(unet_sd, tmp_path / "unet.pt")
    cfg = Config().replace(vae=VAEConfig(**VAE), model=ModelConfig(**UNET2D))
    tconfig.save_config(cfg, str(tmp_path / "c.yaml"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["import-weights", "--config", str(tmp_path / "c.yaml"), "--vae",
                         str(tmp_path / "vae.safetensors"), "--unet", str(tmp_path / "unet.pt"), "--out",
                         str(tmp_path / "imported")]) == 0
    lines = buf.getvalue().splitlines()
    assert "vae: loaded" in lines[0] and "0 source keys unused" in lines[0]
    for name, fn, sd, sub in (("vae", timport.import_vae, vae_sd, cfg.vae),
                              ("unet", timport.import_unet2d, unet_sd, cfg.model)):
        want = fn(sd, sub)
        want.pop("__report__")
        got = torch.load(tmp_path / "imported" / f"{name}.pt", weights_only=True)
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
        info = json.loads(next(line for line in lines if f'"component": "{name}"' in line))
        assert info["unused_source_keys"] == [] and info["missing_in_source"] == [] and info["loaded"] == len(want)
