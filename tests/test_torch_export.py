"""The exported denoise step (emox_torch.infer.export) and the registered ops
behind it (emox_torch.ops.registry).

The tiny preset's step (2 frames, 32^2, float32) is exported, saved,
loaded and run against the reference's EMOModel.predict_noise on the same
flax params (1e-5) and against the eager port (1e-6). Under the kernel
switches (attention "auto" with the K/V cutoff lowered, EMOX_LN_QKV,
EMOX_GROUPNORM_IMPL=pallas / fast) the exported graph holds the port's op
at every site where the eager step calls a kernel wrapper, counted against
the eager step's op calls. Each op's fake implementation gives its real
implementation's shapes, types and strides, and torch.library.opcheck
passes on each op's CPU implementation.
"""

from __future__ import annotations

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from emox_torch.infer.export import export_denoise_step, export_switches, kernel_nodes, load_exported, save_exported
from emox_torch.models.emo import EMOModel
from emox_torch.ops import attention as tattn
from emox_torch.ops import registry
from emox_torch.ops.groupnorm import group_norm

from tests.test_torch_bridge import FRAMES, IMAGE, model_params, no_kernel_launches, rel_err  # noqa: F401

KERNELS = ("flash_attn_nlc_fwd", "flash_attn_nlc_bwd", "flash_attn_fwd", "flash_attn_bwd", "ln_geglu_ff", "geglu_ff",
           "ln_qkv", "group_norm", "group_norm_stats")


def _inputs(cfg, seed: int = 0):
    """The step's inputs after the parameters, as numpy arrays (batch 1)."""
    rng = np.random.default_rng(seed)
    lat = IMAGE // cfg.vae.downscale
    yy, xx = np.mgrid[:IMAGE, :IMAGE]
    mask = (((yy - IMAGE / 2) ** 2 + (xx - IMAGE / 2) ** 2) < (IMAGE / 3) ** 2).astype(np.float32)
    return (rng.standard_normal((1, FRAMES, lat, lat, cfg.model.in_channels)).astype(np.float32),
            np.array([321], np.int32),
            rng.standard_normal((1, lat, lat, cfg.model.in_channels)).astype(np.float32),
            rng.standard_normal((1, FRAMES, 2 * cfg.audio.context_frames + 1, cfg.audio.hidden_dim)).astype(np.float32),
            rng.uniform(-1, 1, (1, FRAMES)).astype(np.float32),
            mask[None, :, :, None])


def _torch(arrays):
    return tuple(torch.from_numpy(np.array(a, copy=True)).long() if a.dtype == np.int32
                 else torch.from_numpy(np.array(a, copy=True)) for a in arrays)


class _CountOps(TorchDispatchMode):
    """Counts the calls of the port's registered ops run under it."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == registry.NAMESPACE:
            self.counts[func._opname] += 1
        return func(*args, **(kwargs or {}))


def _eager_op_calls(model, args):
    """The eager step's kernel-wrapper calls, each sent through its op."""
    with _CountOps() as mode, torch.no_grad(), registry.through_ops():
        out = model.predict_noise(args[0], args[1], args[2], audio_windows=args[3], speeds=args[4],
                                  face_mask=args[5])
    return out, dict(mode.counts)


def test_exported_step_matches_the_reference_and_the_eager_step(tmp_path):
    jm, params, tcfg = model_params("tiny")
    tm = EMOModel(tcfg, device="cpu", seed=1).load_flax(params)
    exported = export_denoise_step(tm, num_frames=FRAMES, image_size=IMAGE, dtype=torch.float32)
    # the artifact holds the program: no weight, constant or example input
    assert not exported.state_dict and not exported.constants and exported.example_inputs is None
    path = save_exported(exported, str(tmp_path / "step.pt2"))
    fn = load_exported(path)
    x = _inputs(jm.config, seed=4)
    args = _torch(x)
    named = dict(tm.modules.named_parameters())
    got = fn(dict(reversed(named.items())), *args)  # the parameters in any order
    want = jm.predict_noise(params, *(jnp.asarray(a) for a in x[:3]), audio_windows=jnp.asarray(x[3]),
                            speeds=jnp.asarray(x[4]), face_mask=jnp.asarray(x[5]))
    assert got.shape == want.shape == x[0].shape
    assert rel_err(got, want) <= 1e-5
    with torch.no_grad():
        eager = tm.predict_noise(args[0], args[1], args[2], audio_windows=args[3], speeds=args[4], face_mask=args[5])
    assert rel_err(got, eager.numpy()) <= 1e-6
    # the default switches on the CPU (conftest pins attention and GroupNorm to
    # "xla"): the FF sub-layers are the only kernel sites, each the op
    _, calls = _eager_op_calls(tm, args)
    assert kernel_nodes(exported) == calls == {"ln_geglu_ff": calls["ln_geglu_ff"]} and calls["ln_geglu_ff"] > 0
    assert export_switches()["EMOX_ATTENTION_IMPL"] == "xla"


def test_exported_graph_holds_an_op_at_every_kernel_site(monkeypatch, tmp_path):
    """Attention "auto" with the K/V cutoff lowered to 1 (every site on the
    kernel route: the tiny preset's head dim 8 takes the strided kernel),
    EMOX_LN_QKV and EMOX_GROUPNORM_IMPL=pallas: the graph's op calls equal
    the eager step's, by kernel, and the loaded step gives the eager bits'
    values."""
    monkeypatch.setenv("EMOX_ATTENTION_IMPL", "auto")
    monkeypatch.setenv("EMOX_LN_QKV", "1")
    monkeypatch.setenv("EMOX_GROUPNORM_IMPL", "pallas")
    monkeypatch.setattr(tattn, "KERNEL_MIN_KV", 1)
    _, params, tcfg = model_params("tiny")
    tm = EMOModel(tcfg, device="cpu", seed=1).load_flax(params)
    args = _torch(_inputs(tm.config, seed=5))
    eager, calls = _eager_op_calls(tm, args)
    exported = export_denoise_step(tm, num_frames=FRAMES, image_size=IMAGE, dtype=torch.float32)
    nodes = kernel_nodes(exported)
    assert nodes == calls
    assert {"flash_attn_fwd", "ln_geglu_ff", "ln_qkv", "group_norm"} <= set(nodes), nodes
    assert export_switches()["KERNEL_MIN_KV"] == 1
    fn = load_exported(save_exported(exported, str(tmp_path / "step.pt2")))
    assert rel_err(fn(dict(tm.modules.named_parameters()), *args), eager.numpy()) <= 1e-6


def test_exported_group_norm_fast_holds_the_stats_op(monkeypatch):
    """EMOX_GROUPNORM_IMPL=fast: K8b's sums through their op, the fold and
    apply in plain ops around it."""
    monkeypatch.setenv("EMOX_GROUPNORM_IMPL", "fast")

    class Norm(torch.nn.Module):
        def forward(self, x, gamma, beta):
            return group_norm(x, gamma, beta, groups=4, silu=True)

    x, gamma, beta = torch.randn(2, 10, 16), torch.randn(16), torch.randn(16)
    exported = torch.export.export(Norm(), (x, gamma, beta), strict=False)
    assert kernel_nodes(exported) == {"group_norm_stats": 1}
    assert torch.equal(exported.module()(x, gamma, beta), Norm()(x, gamma, beta))


def _cases():
    """(op name, CPU inputs) at small shapes, float32 and bfloat16."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s, dtype=torch.float32: torch.randn(s, generator=g).to(dtype)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = r(2, 6, 32, dtype=dt), r(2, 9, 32, dtype=dt), r(2, 9, 32, dtype=dt)
        o, lse = tattn.attention_nlc_plain(q, k, v, 2, 0.25)
        cases.append(("flash_attn_nlc_fwd", (q, k, v, 2, 0.25)))
        for need in ((True, True), (True, False), (False, True)):
            cases.append(("flash_attn_nlc_bwd", (q, k, v, o, lse, r(2, 6, 32, dtype=dt), 2, 0.25, *need)))
        qs, ks = r(1, 2, 6, 12, dtype=dt), r(1, 2, 5, 12, dtype=dt)
        os_, lses = tattn.attention_plain(qs, ks, ks, 12 ** -0.5)
        cases.append(("flash_attn_fwd", (qs, ks, ks, 12 ** -0.5)))
        cases.append(("flash_attn_bwd", (qs, ks, ks, os_, lses, r(1, 2, 6, 12, dtype=dt), 12 ** -0.5, True, True)))
        x = r(3, 4, 16, dtype=dt)
        ln = (1 + 0.1 * r(16), 0.1 * r(16))
        ln = tuple(t.to(dt) for t in ln)
        ff = (r(64, 16, dtype=dt), r(64, dtype=dt), r(16, 32, dtype=dt), r(16, dtype=dt))
        cases.append(("ln_geglu_ff", (x, *ln, *ff, 1e-5)))
        cases.append(("geglu_ff", (x, *ff)))
        cases.append(("ln_qkv", (x, *ln, r(8, 16, dtype=dt), r(8, 16, dtype=dt), r(8, 16, dtype=dt), 1e-5)))
        cases.append(("group_norm", (r(2, 10, 16, dtype=dt), *ln, 4, 1e-5, True)))
        cases.append(("group_norm_stats", (r(2, 10, 16, dtype=dt),)))
    return cases


CASES = _cases()


def test_every_kernel_is_a_registered_op():
    assert set(registry.OPS) == set(KERNELS)
    assert {name for name, _ in CASES} == set(KERNELS)


@pytest.mark.parametrize("name,args", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_fake_implementation_gives_the_real_shapes_and_types(name, args):
    from torch._subclasses.fake_tensor import FakeTensorMode

    op = registry.OPS[name]
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    real = [real] if isinstance(real, torch.Tensor) else list(real)
    fake = [fake] if isinstance(fake, torch.Tensor) else list(fake)
    assert [(t.shape, t.dtype, t.stride()) for t in fake] == [(t.shape, t.dtype, t.stride()) for t in real]


@pytest.mark.parametrize("name,args", CASES[:len(CASES) // 2], ids=[n for n, _ in CASES[:len(CASES) // 2]])
def test_opcheck_passes_on_the_cpu_implementation(name, args):
    torch.library.opcheck(registry.OPS[name], args)


def test_eager_calls_on_plain_tensors_skip_the_dispatcher_and_fakes_take_the_op():
    x, ln = torch.randn(3, 16), (torch.ones(16), torch.zeros(16))
    ff = (torch.randn(64, 16), torch.zeros(64), torch.randn(16, 32), torch.zeros(16))
    from emox_torch.ops import fused_ln_geglu_ff

    with _CountOps() as mode:
        direct = fused_ln_geglu_ff(x, *ln, *ff)
    assert not mode.counts
    with registry.through_ops(), _CountOps() as mode:
        through = fused_ln_geglu_ff(x, *ln, *ff)
    assert mode.counts == {"ln_geglu_ff": 1} and torch.equal(direct, through)
    meta = torch.zeros(3, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_ln_geglu_ff(meta, *(torch.zeros(16, device="meta"),) * 2, *(t.to("meta") for t in ff))
