"""The GroupNorm kernels' launch plan and card path, on the CPU.

K8a (`fused_group_norm`) and K8b (`group_norm_stats`) launch
emox_torch/csrc/group_norm.cu by `gn_plan`: one launch, a thread-block
cluster per sample, where a sample's slab fits the clusters' shared memory
and the card holds every sample's cluster at once; else two launches (row
chunks' statistics, then the apply or the finalize). The plan is checked at
every GroupNorm slab of the flagship's 256^2 and 512^2 UNet passes and VAE
encodes and decodes, as the modules run them (recorded on the meta device).
`build.kernel` hands the wrappers stand-in C entries that check the plan
they are given, and that compute the plain versions. The stage-5 step's K8a
launches are held against chip_smoke.py's count.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import chip_smoke
from emox_torch import ops
from emox_torch.core.config import VAEConfig
from emox_torch.core.presets import flagship_config
from emox_torch.models.emo import EMOModel
from emox_torch.models.unet import UNet
from emox_torch.models.vae import AutoencoderKL
from emox_torch.nn import blocks
from emox_torch.ops import build
from emox_torch.ops import groupnorm as tgn
from emox_torch.train import Trainer
from tests.test_torch_512 import VAE_512, VAE_IMAGE
from tests.test_torch_bridge import configs, no_kernel_launches  # noqa: F401 (autouse fixture)
from tests.test_torch_ops import BF16_TOL, FP32_TOL, rel

SMS = 132
# clusters the H100 holds at once (cudaOccupancyMaxActiveClusters), bf16 K8a
# blocks, by (L, C) and cluster size, measured for the 256^2 / 512^2 slabs
# (chip_probe_norms.py's `held` lines)
HELD = {(1024, 320): {4: 30, 5: 22, 6: 17, 7: 32, 8: 30, 9: 23, 10: 21, 11: 16, 12: 28, 13: 23, 14: 21, 15: 21, 16: 21},
        (256, 640): {2: 66, 3: 39, 4: 62, 5: 47, 6: 62, 7: 47, 8: 45, 9: 37, 10: 44, 11: 37, 12: 37, 13: 30, 14: 30,
                     15: 28, 16: 28},
        (1024, 640): {7: 15, 8: 15, 9: 9, 10: 7, 11: 7, 12: 7, 13: 7, 14: 14, 15: 14, 16: 14},
        (4096, 320): {13: 7, 14: 7, 15: 7, 16: 7},
        (1024, 512): {5: 22, 6: 17, 7: 15, 8: 15, 9: 9, 10: 7, 11: 7, 12: 16, 13: 14, 14: 14, 15: 14, 16: 14}}


def _slabs(path: str, size: int) -> set:
    """The (N, L, C) of every GroupNorm call of one flagship UNet pass
    under CFG at 16 frames ("unet") or of a VAE encode of one image and a
    decode of 16 frames ("vae"), at size^2: the modules run on the meta
    device with each FusedGroupNorm recording its input."""
    seen = set()

    def record(self, x, silu=None):
        seen.add((x.shape[:-3].numel(), x.shape[-3] * x.shape[-2], x.shape[-1]))
        return x

    cfg = flagship_config(image_size=size, num_frames=16)
    saved = blocks.FusedGroupNorm.forward
    blocks.FusedGroupNorm.forward = record
    try:
        with torch.device("meta"):
            if path == "unet":
                m, h = cfg.model, size // 8
                UNet(m)(torch.empty(2, 16, h, h, m.in_channels), torch.zeros(2),
                        audio=torch.empty(2, 16, 5, m.audio_context_dim), speeds=torch.empty(2, 16, m.speed_axes))
            else:
                vae = AutoencoderKL(cfg.vae)
                vae.encode(torch.empty(1, size, size, 3))
                vae.decode(torch.empty(16, size // 8, size // 8, 4))
    finally:
        blocks.FusedGroupNorm.forward = saved
    return seen


def _held(l: int, c: int):
    table = HELD.get((l, c))
    return None if table is None else (lambda k, rows: table.get(k, 0))


@pytest.mark.parametrize("path,size", [("unet", 256), ("unet", 512), ("vae", 256), ("vae", 512)],
                         ids=["unet_256", "unet_512", "vae_256", "vae_512"])
def test_plan_at_every_group_norm_slab(monkeypatch, path, size):
    """Every slab gets a plan the kernels take: a cluster of 1-16 blocks
    whose rows fit the block's shared memory (K8a), none empty, 1.5 blocks
    an SM where the slab allows; or two launches whose statistics fit 48
    KB. In bf16 every slab of the 256^2 UNet fits a cluster; the VAE's
    full-resolution maps do not, and take two launches in K8b too. Where
    the H100's clusters-held count is known (HELD), the plan uses it."""
    monkeypatch.setenv("EMOX_FF_IMPL", "xla")  # the plain FF on the meta device
    slabs = _slabs(path, size)
    assert len(slabs) > 5
    regimes = {}
    for n, l, c in sorted(slabs):
        for itemsize in (2, 4):
            regime, k, chunks = tgn.gn_plan(n, l, c, itemsize, active=_held(l, c) if itemsize == 2 else None)
            regimes[n, l, c, itemsize] = regime
            if regime == "cluster":
                rows = -(-l // k)
                assert 1 <= k <= 16 and chunks == k
                assert tgn.gn_smem(rows, c, itemsize) <= tgn.SMEM_MAX
                assert k == 1 or rows * (k - 1) < l
                assert 2 * n * k >= 3 * SMS or k == 16 or -(-l // (k + 1)) * k >= l
            else:
                assert regime == "two_launch" and k == 0 and chunks >= 1
                vpr = c * itemsize // 16
                assert 2 * (256 // vpr if vpr <= 256 else 1) * c * 4 <= 48 * 1024
            stats = tgn.gn_plan(n, l, c, itemsize, apply=False)
            fits16 = tgn.gn_smem(-(-l // 16), c, itemsize) <= tgn.SMEM_MAX
            assert stats == ("two_launch", 0, tgn.stats_chunks(n, l, c, itemsize)) if not fits16 else (
                stats[0] == "cluster" and 1 <= stats[1] <= 16 and -(-l // stats[1]) * (stats[1] - 1) < l)
    if (path, size) == ("unet", 256):  # each bf16 slab fits a cluster (the card may hold too few at once)
        assert all(tgn.gn_plan(n, l, c, 2)[0] == "cluster" for n, l, c in slabs)
    if path == "vae":
        assert regimes[16, size * size, 128, 2] == "two_launch"


def test_plan_puts_every_sample_in_one_wave():
    """With the H100's clusters-held counts: the smallest cluster of 1.5
    blocks an SM or more that holds all N samples at once (7 at UNet level
    0: 32 clusters of 7 fit, 30 of 8), else two launches (512^2 levels 0
    and 1, the VAE's 16-frame decode at 32^2). K8b: 8 blocks, 16 where a
    block would stream more than 64 KB."""
    assert tgn.gn_plan(32, 1024, 320, 2, active=_held(1024, 320)) == ("cluster", 7, 7)
    assert tgn.gn_plan(32, 256, 640, 2, active=_held(256, 640)) == ("cluster", 7, 7)
    assert tgn.gn_plan(32, 4096, 320, 2, active=_held(4096, 320))[0] == "two_launch"
    assert tgn.gn_plan(32, 1024, 640, 2, active=_held(1024, 640))[0] == "two_launch"
    assert tgn.gn_plan(16, 1024, 512, 2, active=_held(1024, 512))[0] == "two_launch"
    assert tgn.gn_plan(32, 256, 640, 2, apply=False) == ("cluster", 8, 8)
    assert tgn.gn_plan(32, 1024, 320, 2, apply=False) == ("cluster", 16, 16)
    assert tgn.gn_plan(16, 65536, 128, 2, apply=False)[0] == "two_launch"


def _view(ptr: int, shape, dtype) -> torch.Tensor:
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=dtype).view(shape)


def _held_anywhere(k: int, rows: int, c: int, groups: int, dtype: int) -> int:
    """A stand-in card: 264 block slots, clusters whole."""
    return 264 // k


@pytest.fixture
def card(monkeypatch):
    """The GroupNorm wrappers' card path on CPU tensors: stand-in C entries
    that check the plan they are given (cluster and chunks as gn_plan_for
    makes them; the partials' scratch only for two launches) and compute the
    plain versions. Returns the calls."""
    calls = []
    types = {1: torch.bfloat16, 0: torch.float32}

    def plan(n, l, c, dtype, groups, apply):
        return tgn.gn_plan(n, l, c, types[dtype].itemsize, groups, apply=apply,
                           active=lambda k, rows: _held_anywhere(k, rows, c, groups, dtype))

    def group_norm(x, gamma, beta, y, part, n, l, c, groups, cluster, chunks, eps, silu, dtype, stream):
        regime, k, ch = plan(n, l, c, dtype, groups, True)
        assert (cluster, chunks) == (k, ch) and (part is None) == (regime == "cluster")
        assert all(p % 16 == 0 for p in (x, gamma, beta, y))
        t = types[dtype]
        out = tgn.group_norm_plain(_view(x, (n, l, c), t), _view(gamma, (c,), t), _view(beta, (c,), t), groups,
                                   eps, bool(silu))
        _view(y, (n, l, c), t).copy_(out)
        calls.append(dict(entry="emox_group_norm", regime=regime, cluster=cluster))
        return 0

    def stats(x, part, sums, n, l, c, cluster, chunks, dtype, stream):
        regime, k, ch = plan(n, l, c, dtype, 32, False)
        assert (cluster, chunks) == (k, ch) and (part is None) == (regime == "cluster")
        s, ss = tgn.group_norm_stats_plain(_view(x, (n, l, c), types[dtype]))
        out = _view(sums, (2, n, c), torch.float32)
        out[0], out[1] = s, ss
        calls.append(dict(entry="emox_group_norm_stats", regime=regime, cluster=cluster))
        return 0

    entries = {"emox_group_norm": group_norm, "emox_group_norm_stats": stats,
               "emox_group_norm_clusters": _held_anywhere}
    monkeypatch.setattr(build, "kernel", lambda name, fn_name="": entries[fn_name])
    monkeypatch.setattr(tgn, "_on_card_or_cpu", lambda name, x: True)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(tgn, "_sm_count", lambda index: SMS)
    # a fresh cache of the stand-in card's answers
    monkeypatch.setattr(tgn, "_clusters_held", functools.lru_cache(maxsize=None)(tgn._clusters_held.__wrapped__))
    yield calls
    ops.reset_launch_counts()


def _x(n, l, c, dtype, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, shift=0.0: torch.from_numpy((rng.standard_normal(s) * scale + shift).astype(np.float32))
    return f(n, l, c, scale=3.0, shift=1.0).to(dtype), f(c, scale=0.1, shift=1.0).to(dtype), f(c, scale=0.1).to(dtype)


# one cluster launch (small slabs, ragged L) and two launches (a slab past 16 blocks' shared memory)
ROUTES = [(4, 100, 64, torch.bfloat16, "cluster"), (2, 1000, 320, torch.float32, "cluster"),
          (2, 8200, 256, torch.bfloat16, "two_launch"), (1, 5000, 512, torch.float32, "two_launch")]


@pytest.mark.parametrize("n,l,c,dtype,regime", ROUTES, ids=[f"n{n}_l{l}_c{c}_{r}" for n, l, c, _, r in ROUTES])
def test_group_norm_launches_by_its_plan(card, n, l, c, dtype, regime):
    """K8a and K8b launch once per call by the plan for the shape (with the
    card's clusters-held count), match their plain versions, and count."""
    x, gamma, beta = _x(n, l, c, dtype, seed=l)
    y = ops.fused_group_norm(x, gamma, beta, 32, silu=True)
    s, ss = ops.group_norm_stats(x)
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    assert rel(y.float(), tgn.group_norm_plain(x, gamma, beta, 32, silu=True).float().numpy()) <= tol
    want_s, want_ss = tgn.group_norm_stats_plain(x)
    assert rel(s, want_s.numpy()) <= FP32_TOL and rel(ss, want_ss.numpy()) <= FP32_TOL
    assert [(d["entry"], d["regime"]) for d in card] == [("emox_group_norm", regime), ("emox_group_norm_stats", regime)]
    assert (ops.fused_group_norm.launches, ops.group_norm_stats.launches) == (1, 1)


def test_stage5_group_norm_launches_match_the_code(monkeypatch, tmp_path):
    """chip_smoke.stage05_launches under EMOX_GROUPNORM_IMPL=pallas against
    the K8a calls one stage-5 train step makes: every GroupNorm of the VAE's
    encode and decode, once (the backward recomputes through the plain
    formula), with test_torch_512's cut of the flagship VAE."""
    calls = []

    def counted(x, gamma, beta, groups, eps, silu):
        calls.append(tuple(x.shape))
        return tgn.group_norm_plain(x, gamma, beta, groups, eps, silu)

    monkeypatch.setenv("EMOX_GROUPNORM_IMPL", "pallas")
    monkeypatch.setattr(tgn, "_on_card_or_cpu", lambda name, x: True)
    monkeypatch.setattr(tgn, "_gn_kernel", counted)
    _, tcfg = configs("tiny")
    cfg = tcfg.replace(vae=VAEConfig(**VAE_512, sample_size=VAE_IMAGE),
                       train=dataclasses.replace(tcfg.train, stage=5, compute_dtype="float32",
                                                 checkpoint_dir=str(tmp_path)))
    tr = Trainer(cfg, model=EMOModel(cfg, device="cpu"))
    images = torch.from_numpy(np.random.default_rng(53).uniform(-1, 1, (2, VAE_IMAGE, VAE_IMAGE, 3)).astype(np.float32))
    assert np.isfinite(float(tr.train_step({"images": images}, torch.Generator().manual_seed(0))["loss"]))
    tr.close()
    want = chip_smoke.stage05_launches(5, env={"EMOX_GROUPNORM_IMPL": "pallas"}, cfg=cfg)
    assert len(calls) == want["group_norm"] == sum(chip_smoke.vae_group_norms(cfg)) > 0
    assert chip_smoke.stage05_launches(5, cfg=cfg)["group_norm"] == 0
