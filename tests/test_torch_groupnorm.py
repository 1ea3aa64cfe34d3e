"""The port's GroupNorm dispatcher and its two kernels' plain versions
against the reference's, on the CPU.

The plain versions (what the kernel wrappers run for CPU tensors) are held
against the reference's Pallas kernels in interpret mode: `_gn_kernel`
(K8a, impl "pallas_interpret") and `_gn_stats_kernel` (K8b, impl
"fast_interpret"), at the reference's own test shapes. Tolerances: float32
<= 1e-5 relative L2; bfloat16 two bf16 steps (2^-8 relative each), since
both sides round once, at the same point. tests/conftest.py pins
EMOX_GROUPNORM_IMPL=xla, so the tests pass `impl` or set the variable with
monkeypatch. The CUDA kernels themselves are checked on the card by
chip_smoke.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emox.ops import groupnorm as jgn
from emox_torch import ops
from emox_torch.ops import groupnorm as tgn
from tests.test_torch_bridge import no_kernel_launches  # noqa: F401 (autouse fixture)
from tests.test_torch_ops import BF16_TOL, FP32_TOL, j, rel, t

SHAPES = [(2, 64, 128, 32), (1, 100, 64, 16), (3, 16, 256, 32)]  # tests/test_ops.py TestGroupNorm
SHAPE_IDS = ["n2_l64_c128", "n1_l100_c64", "n3_l16_c256"]


def _inputs(n, l, c, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, l, c)) * 3 + 1).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("silu", [False, True], ids=["plain", "silu"])
@pytest.mark.parametrize("n,l,c,g", SHAPES, ids=SHAPE_IDS)
def test_k8a_plain_matches_pallas_interpret(n, l, c, g, silu):
    """group_norm_plain, the autograd wrapper and the dispatcher under
    "pallas" against the reference's _gn_kernel in interpret mode."""
    x, gamma, beta = _inputs(n, l, c)
    want = jgn.group_norm(j(x), j(gamma), j(beta), g, silu=silu, impl="pallas_interpret")
    assert rel(tgn.group_norm_plain(t(x), t(gamma), t(beta), g, silu=silu), want) <= FP32_TOL
    assert rel(ops.fused_group_norm(t(x), t(gamma), t(beta), g, silu=silu), want) <= FP32_TOL
    assert rel(ops.group_norm(t(x), t(gamma), t(beta), g, silu=silu, impl="pallas"), want) <= FP32_TOL


@pytest.mark.parametrize("silu", [False, True], ids=["plain", "silu"])
@pytest.mark.parametrize("n,l,c,g", SHAPES, ids=SHAPE_IDS)
def test_k8b_plain_and_fast_path_match_fast_interpret(n, l, c, g, silu):
    """group_norm_stats_plain against the reference's _gn_stats_kernel in
    interpret mode, and the dispatcher under "fast" against the reference's
    group_norm_fast (the same kernel, then the XLA apply)."""
    x, gamma, beta = _inputs(n, l, c, seed=1)
    s_want, ss_want = jgn._gn_stats_pallas(j(x), interpret=True)
    s_got, ss_got = ops.group_norm_stats(t(x))
    assert s_got.shape == ss_got.shape == (n, c) and s_got.dtype == torch.float32
    assert rel(s_got, s_want) <= FP32_TOL and rel(ss_got, ss_want) <= FP32_TOL
    want = jgn.group_norm(j(x), j(gamma), j(beta), g, silu=silu, impl="fast_interpret")
    assert rel(ops.group_norm(t(x), t(gamma), t(beta), g, silu=silu, impl="fast"), want) <= FP32_TOL


@pytest.mark.parametrize("silu", [False, True], ids=["plain", "silu"])
@pytest.mark.parametrize("impl", ["pallas", "fast"])
def test_bf16_rounds_like_the_reference_kernels(impl, silu):
    """bf16 x with float32 gamma and beta, as the reference's bf16 model
    holds them: K8a's plain version rounds once after the fp32 apply, as
    _gn_kernel does; the fast path applies x * a + b in bf16, as the
    reference's XLA apply does."""
    x, gamma, beta = _inputs(2, 64, 128, seed=2)
    want = jgn.group_norm(j(x, jnp.bfloat16), j(gamma), j(beta), 32, silu=silu, impl=f"{impl}_interpret")
    got = ops.group_norm(t(x, torch.bfloat16), t(gamma), t(beta), 32, silu=silu, impl=impl)
    assert got.dtype == torch.bfloat16
    assert rel(got, want) <= BF16_TOL


@pytest.mark.parametrize("impl", ["pallas", "fast"])
def test_grads_match_jax_grad(impl):
    """The autograd functions' backward (recompute through group_norm_xla)
    against jax.grad through the reference's custom VJPs, for x, gamma and
    beta (tests/test_ops.py TestGroupNorm.test_grad_matches, with non-unit
    gamma and beta)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(64)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    loss = lambda a, b, c: jnp.sum(jgn.group_norm(a, b, c, 16, silu=True, impl=f"{impl}_interpret") * w)
    want = jax.grad(loss, argnums=(0, 1, 2))(j(x), j(gamma), j(beta))
    args = [t(a).requires_grad_() for a in (x, gamma, beta)]
    y = ops.group_norm(*args, 16, silu=True, impl=impl)
    assert type(y.grad_fn).__name__ in ("_GroupNormFusedBackward", "_GroupNormFastBackward")
    got = torch.autograd.grad((y * t(w)).sum(), args)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        assert rel(a, b) <= FP32_TOL, name
    # only x needs a gradient: the backward asks for dx alone
    (dx,) = torch.autograd.grad((ops.group_norm(args[0], t(gamma), t(beta), 16, silu=True, impl=impl)
                                 * t(w)).sum(), (args[0],))
    assert rel(dx, want[0]) <= FP32_TOL


# EMOX_GROUPNORM_IMPL -> (the value the reference is given on the CPU, the path both take)
ROUTES = [(None, None, "xla"), ("", "", "xla"), ("xla", "xla", "xla"),
          ("pallas", "pallas_interpret", "pallas"), ("fast", "fast_interpret", "fast")]


@pytest.mark.parametrize("env,ref_env,route", ROUTES, ids=["unset", "empty", "xla", "pallas", "fast"])
def test_switch_routes_like_the_reference(monkeypatch, env, ref_env, route):
    """EMOX_GROUPNORM_IMPL sends the port's group_norm down the path the
    reference's group_norm takes (spied on both sides, read at call time),
    and both compute the same values."""
    taken = {"ref": [], "port": []}

    def spy(side, label, fn):
        def run(*a, **kw):
            taken[side].append(label)
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(jgn, "group_norm_xla", spy("ref", "xla", jgn.group_norm_xla))
    monkeypatch.setattr(jgn, "_gn_fused", spy("ref", "pallas", jgn._gn_fused))
    monkeypatch.setattr(jgn, "_gn_fast", spy("ref", "fast", jgn._gn_fast))
    monkeypatch.setattr(tgn, "group_norm_xla", spy("port", "xla", tgn.group_norm_xla))
    monkeypatch.setattr(tgn, "group_norm_plain", spy("port", "pallas", tgn.group_norm_plain))
    monkeypatch.setattr(tgn, "group_norm_fast", spy("port", "fast", tgn.group_norm_fast))
    x, gamma, beta = _inputs(2, 64, 128, seed=4)
    for var, value in (("ref", ref_env), ("port", env)):
        if value is None:
            monkeypatch.delenv("EMOX_GROUPNORM_IMPL", raising=False)
        else:
            monkeypatch.setenv("EMOX_GROUPNORM_IMPL", value)
        if var == "ref":
            want = jgn.group_norm(j(x), j(gamma), j(beta), 32, silu=True)
        else:
            got = tgn.group_norm(t(x), t(gamma), t(beta), 32, silu=True)
    assert taken["ref"] == taken["port"] == [route]
    assert rel(got, want) <= FP32_TOL


def test_unknown_impl_raises(monkeypatch):
    x, gamma, beta = (t(a) for a in _inputs(1, 16, 64))
    monkeypatch.setenv("EMOX_GROUPNORM_IMPL", "triton")
    with pytest.raises(ValueError, match="'xla', 'pallas', 'fast', 'pallas_interpret' or 'fast_interpret'"):
        ops.group_norm(x, gamma, beta, 32)
    with pytest.raises(ValueError, match="'fast_interpret', got 'pallas_tpu'"):
        ops.group_norm(x, gamma, beta, 32, impl="pallas_tpu")
    with pytest.raises(ValueError, match="not divisible"):
        ops.group_norm(x, gamma, beta, 12, impl="pallas")


def test_slab_past_the_references_vmem_cutoff_takes_the_kernel(monkeypatch):
    """L * C * 4 bytes above the reference's 8 MB cutoff: the reference
    falls back to group_norm_xla, the port still takes K8a (its plain
    version here); in float32 both give the same values."""
    n, l, c = 1, 8200, 256
    assert l * c * 4 > jgn._VMEM_BUDGET_BYTES
    x, gamma, beta = _inputs(n, l, c, seed=5)
    want = jgn.group_norm(j(x), j(gamma), j(beta), 32, silu=True, impl="pallas_interpret")
    monkeypatch.setattr(tgn, "group_norm_xla", lambda *a, **k: pytest.fail("the port took the plain path"))
    got = ops.group_norm(t(x), t(gamma), t(beta), 32, silu=True, impl="pallas")
    assert rel(got, want) <= FP32_TOL


def test_4d_input_and_group_norm_silu():
    """x [..., L, C] with two leading dims (tests/test_ops.py
    TestGroupNorm.test_4d_input), and the SiLU shorthand."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 16, 32)).astype(np.float32)
    gamma, beta = np.ones(32, np.float32), np.zeros(32, np.float32)
    want = jgn.group_norm(j(x), j(gamma), j(beta), 8, impl="pallas_interpret")
    got = ops.group_norm(t(x), t(gamma), t(beta), 8, impl="pallas")
    assert got.shape == x.shape and rel(got, want) <= FP32_TOL
    want_silu = jgn.group_norm_silu(j(x), j(gamma), j(beta), 8, impl="fast_interpret")
    assert rel(ops.group_norm_silu(t(x), t(gamma), t(beta), 8, impl="fast"), want_silu) <= FP32_TOL


def test_kernel_wrappers_check_before_launching():
    """What the kernels refuse is refused before any launch, and a tensor on
    neither the card nor the CPU is refused by name."""
    x = torch.zeros(2, 16, 64)
    g = torch.ones(64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tgn._gn_kernel(x.half(), g.half(), g.half(), 32, 1e-5, True)
    with pytest.raises(ValueError, match="multiple of 8"):
        tgn._gn_kernel(torch.zeros(2, 16, 36, dtype=torch.bfloat16), *(torch.ones(36, dtype=torch.bfloat16),) * 2,
                       4, 1e-5, True)
    with pytest.raises(TypeError, match="in x's type"):
        tgn._gn_kernel(x, g.bfloat16(), g, 32, 1e-5, True)
    with pytest.raises(ValueError, match=r"x \[N, L, C\]"):
        tgn._gn_kernel(x[0], g, g, 32, 1e-5, True)
    meta = torch.zeros(2, 16, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.fused_group_norm(meta, g, g, 32)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.group_norm_stats(meta)


@pytest.mark.parametrize("n,l,c,itemsize,chunks", [
    (32, 1024, 320, 2, 17),  # UNet level 0 under CFG: 544 blocks
    (32, 64, 1280, 2, 17),   # level 2: 160 vectors a row, one row per pass
    (16, 65536, 128, 2, 33),  # the VAE's full-resolution decode of 16 frames
    (1, 8, 1280, 4, 8),      # a short slab: one chunk per row
], ids=["unet_l0", "unet_l2", "vae_full_res", "short"])
def test_kernel_grid_fills_the_card(n, l, c, itemsize, chunks):
    assert tgn.stats_chunks(n, l, c, itemsize) == chunks
