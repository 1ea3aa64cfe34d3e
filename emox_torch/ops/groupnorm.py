"""GroupNorm(+SiLU) for the port: the dispatcher, its two kernels and the
plain paths.

Counterpart of emox/ops/groupnorm.py. `group_norm` chooses the path as the
reference's does, from `impl` or else EMOX_GROUPNORM_IMPL, read at call time
(the reference reads it when it traces):

  * "xla" (the default, and an unset or empty variable): `group_norm_xla`,
    plain PyTorch;
  * "pallas": the TPU kernel `_gn_kernel` (K8a) becomes the CUDA kernel
    `group_norm` (emox_torch/csrc/group_norm.cu), behind the autograd
    function `fused_group_norm`;
  * "fast": the TPU kernel `_gn_stats_kernel` (K8b) becomes the CUDA kernel
    `group_norm_stats` (the same source), and `group_norm_fast` folds its
    per-channel sums into `x * a + b` applied in plain PyTorch, as the
    reference applies it in XLA;
  * "pallas_interpret" and "fast_interpret", the reference's debug routes:
    the kernels' plain versions on any device, `group_norm_plain` and
    `group_norm_fast` on the plain statistics (`group_norm_stats_plain`),
    as `fused_interpret` in emox_torch/ops/ff.py;
  * any other value raises ValueError.

Each kernel wrapper launches its kernel on a CUDA tensor, or raises for an
input it does not take; there is no fallback. On a CPU tensor it runs the
kernel's plain version (`group_norm_plain`, `group_norm_stats_plain`), which
the CPU tests hold against the reference's kernels in interpret mode. Both
kernels' gradients recompute through `group_norm_xla`, as the reference's
`_gn_fused_bwd` and `_gn_fast_bwd` do: neither has a backward kernel.

Both kernels launch by `gn_plan`: where a sample's slab fits the shared
memory of a thread-block cluster (up to 16 blocks) and, for K8a, the card
holds every sample's cluster at once (most of the UNet's GroupNorms in
bfloat16), one launch with a cluster per sample; else two, the statistics
over row chunks and then the apply (K8a) or the sums' finalize (K8b).

The reference sends a sample's slab to XLA instead of `_gn_kernel` when
L * C * 4 bytes exceed 8 MB, its TPU's VMEM budget (the VAE's wide sites).
The CUDA kernels take every site, so under "pallas" those sites round as
`_gn_kernel` rounds (fp32 apply, one cast) where the reference rounds as
`group_norm_xla` does: in bfloat16 the two differ by a bf16 step here and
there, in float32 not at all beyond summation order.

Rounding of `group_norm_xla` follows the reference, not torch's
F.group_norm: statistics accumulate in fp32, the map is applied as one
`x * a + b` in x's own type with per-channel coefficients folded in fp32.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional, Tuple

import torch

from emox_torch.ops import build
from emox_torch.ops.attention import _on_card_or_cpu
from emox_torch.ops.ff import _sm_count

IMPLS = ("xla", "pallas", "fast", "pallas_interpret", "fast_interpret")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # kGNThreads in csrc/group_norm.cu
_SMS = 132  # the H100's SMs
_TARGET_BLOCKS = 4 * _SMS  # a few blocks per SM
SMEM_MAX = 232448  # the 227 KB of shared memory a block may use (kSmemMax)
MAX_CLUSTER = 16  # blocks per sample in the one-launch regime (the non-portable cluster size)


def group_norm_xla(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
                   eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """x [..., L, C] normalised over (L, C // groups) per group."""
    *lead, l, c = x.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    cg = c // groups
    xg = x.reshape(*lead, l, groups, cg).float()
    mean = xg.mean(dim=(-3, -1), keepdim=True)  # [..., 1, G, 1]
    var = xg.square().mean(dim=(-3, -1), keepdim=True) - mean.square()
    inv = torch.rsqrt(var + eps)
    ones = [1] * len(lead)
    gamma_g = gamma.float().reshape(*ones, 1, groups, cg)
    beta_g = beta.float().reshape(*ones, 1, groups, cg)
    a = (gamma_g * inv).reshape(*lead, 1, c)
    b = (beta_g - mean * gamma_g * inv).reshape(*lead, 1, c)
    xn = x * a.to(x.dtype) + b.to(x.dtype)
    if silu:
        xn = xn * torch.sigmoid(xn)
    return xn


def group_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
                     eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """K8a's function in plain PyTorch, with `_gn_kernel`'s rounding: fp32
    statistics, y = (x - mean) * inv * gamma + beta in fp32, SiLU, then one
    cast to x's type. x [..., L, C]."""
    *lead, l, c = x.shape
    cg = c // groups
    xg = x.reshape(*lead, l, groups, cg).float()
    mean = xg.mean(dim=(-3, -1), keepdim=True)
    var = xg.square().mean(dim=(-3, -1), keepdim=True) - mean.square()
    inv = torch.rsqrt(var + eps)
    y = (xg - mean) * inv * gamma.float().reshape(groups, cg) + beta.float().reshape(groups, cg)
    if silu:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def group_norm_stats_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8b's function in plain PyTorch: x [N, L, C] -> per-channel fp32 sum
    and sum of squares over L, [N, C] each."""
    xf = x.float()
    return xf.sum(dim=1), xf.square().sum(dim=1)


def stats_chunks(n: int, l: int, c: int, itemsize: int) -> int:
    """Row chunks per sample of the kernels' grid (chunks x N blocks): enough
    blocks to keep every SM busy, and no chunk shorter than one pass of a
    block's threads over the rows."""
    vpr = c * itemsize // 16  # 16-byte vectors per row
    rows_per_pass = max(1, _THREADS // vpr)
    return max(1, min(-(-l // rows_per_pass), -(-_TARGET_BLOCKS // n)))


def gn_smem(rows: int, c: int, itemsize: int, groups: int = 32, apply: bool = True) -> int:
    """Shared memory of one block of the one-launch regime (cluster_smem in
    csrc/group_norm.cu): its rows of x (K8a only), then in fp32 the tree of
    per-thread partials [2, rows per pass, C], the totals [2, C] and the
    group statistics [2, groups], then the mbarriers of its 16 bulk copies
    at most."""
    align16 = lambda b: -(-b // 16) * 16
    vpr = c * itemsize // 16
    rpp = _THREADS // vpr if vpr <= _THREADS else 1
    slab = align16(rows * c * itemsize) if apply else 0
    return slab + align16(4 * (2 * rpp * c + 2 * c + 2 * groups)) + 8 * 16


def gn_plan(n: int, l: int, c: int, itemsize: int, groups: int = 32, sms: int = _SMS, apply: bool = True,
            active: Optional[Callable[[int, int], int]] = None) -> Tuple[str, int, int]:
    """How the GroupNorm kernels run on x [n, l, c]: (regime, cluster, chunks).
    The rules follow the regimes' device times on the H100
    (chip_probe_norms.py).

    "cluster": one launch, a cluster of `cluster` blocks (1-16) per sample
    (chunks == cluster). K8a (apply): each block holds ceil(l / cluster)
    rows in shared memory. The candidates are the sizes whose rows fit a
    block and leave no block empty, with at least 1.5 blocks an SM where
    the slab allows; the plan takes the smallest that puts all n clusters
    on the card at once, as `active(k, rows)` counts them (the card's
    cudaOccupancyMaxActiveClusters; None: unbounded). K8b (apply False)
    streams its rows: 8 blocks a sample, 16 where a block's rows would pass
    64 KB.
    "two_launch": cluster 0, and `chunks` row chunks per sample
    (stats_chunks) for the statistics and then the apply (K8a) or the
    finalize (K8b). K8a where no candidate holds all samples at once (in a
    second wave a sample waits for a whole earlier one): 512^2's level-0
    slabs, the VAE's wide maps; K8b where the slab does not fit 16 blocks'
    shared memory (the VAE's full-resolution maps)."""
    rows = lambda k: -(-l // k)
    fits = [k for k in range(1, MAX_CLUSTER + 1)
            if gn_smem(rows(k), c, itemsize, groups) <= SMEM_MAX and (k == 1 or rows(k) * (k - 1) < l)]
    if not fits:
        return "two_launch", 0, stats_chunks(n, l, c, itemsize)
    if not apply:
        k = 8 if rows(8) * c * itemsize <= 65536 else 16
        while k > 1 and rows(k) * (k - 1) >= l:
            k -= 1
        return "cluster", k, k
    full = [k for k in fits if 2 * n * k >= 3 * sms] or fits[-1:]
    pick = next((k for k in full if active is None or active(k, rows(k)) >= n), None)
    if pick is None:
        return "two_launch", 0, stats_chunks(n, l, c, itemsize)
    return "cluster", pick, pick


def gn_plan_for(x: torch.Tensor, groups: int = 32, apply: bool = True) -> Tuple[str, int, int]:
    """gn_plan for x [N, L, C] on its card, with its SMs and the clusters it
    holds at once: the plan the kernel wrappers launch by."""
    n, l, c = x.shape
    index, dtype = x.device.index or 0, _DTYPES[x.dtype]
    return gn_plan(n, l, c, x.element_size(), groups, _sm_count(index), apply,
                   active=lambda k, rows: _clusters_held(index, k, rows, c, groups, dtype))


@functools.lru_cache(maxsize=None)
def _clusters_held(index: int, k: int, rows: int, c: int, groups: int, dtype: int) -> int:
    """How many clusters of k K8a blocks of `rows` rows the card holds at
    once (emox_group_norm_clusters)."""
    with torch.cuda.device(index):
        got = build.kernel("group_norm", "emox_group_norm_clusters")(k, rows, c, groups, dtype)
    if got < 0:
        build.check(-got, "group_norm_clusters")
    return got


def _check_x(name: str, x: torch.Tensor) -> Tuple[int, int, int]:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name} takes x [N, L, C], got {tuple(x.shape)}")
    n, l, c = x.shape
    vec = 16 // x.element_size()
    if c % vec or n > 65535:
        raise ValueError(f"{name}: C must be a multiple of {vec} for {x.dtype} and N at most 65535, "
                         f"got {tuple(x.shape)}")
    return n, l, c


def _gn_kernel(x, gamma, beta, groups: int, eps: float, silu: bool) -> torch.Tensor:
    n, l, c = _check_x("group_norm", x)
    if c % groups:
        raise ValueError(f"group_norm: channels {c} not divisible by groups {groups}")
    if any(p.dtype != x.dtype or p.device != x.device or tuple(p.shape) != (c,) for p in (gamma, beta)):
        raise TypeError(f"group_norm needs gamma and beta [{c}] on x's device and in x's type")
    xc = x.contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    if xc.data_ptr() % 16:
        raise ValueError("group_norm needs a 16-byte aligned x")
    _, cluster, chunks = gn_plan_for(xc, groups)
    y = torch.empty_like(xc)
    part = None if cluster else torch.empty((2, n, chunks, c), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = build.kernel("group_norm", "emox_group_norm")(
            xc.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), None if part is None else part.data_ptr(),
            n, l, c, groups, cluster, chunks, float(eps), int(silu), _DTYPES[x.dtype], stream,
        )
    build.check(err, "group_norm")
    fused_group_norm.launches += 1
    return y


def group_norm_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel fp32 sum and sum of squares of x [N, L, C] over L, [N, C]
    each. Launches the CUDA kernel for CUDA tensors and runs the plain
    version for CPU tensors."""
    if not _on_card_or_cpu("group_norm_stats", x):
        return group_norm_stats_plain(x)
    n, l, c = _check_x("group_norm_stats", x)
    xc = x.contiguous()
    if xc.data_ptr() % 16:
        raise ValueError("group_norm_stats needs a 16-byte aligned x")
    _, cluster, chunks = gn_plan_for(xc, apply=False)
    part = None if cluster else torch.empty((2, n, chunks, c), device=x.device, dtype=torch.float32)
    sums = torch.empty((2, n, c), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = build.kernel("group_norm", "emox_group_norm_stats")(
            xc.data_ptr(), None if part is None else part.data_ptr(), sums.data_ptr(), n, l, c, cluster, chunks,
            _DTYPES[x.dtype], stream,
        )
    build.check(err, "group_norm_stats")
    group_norm_stats.launches += 1
    return sums[0], sums[1]


group_norm_stats.launches = 0  # kernel launches since the last reset


def group_norm_fast(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
                    eps: float = 1e-5, silu: bool = False, stats=None) -> torch.Tensor:
    """The reference's group_norm_fast on x [N, L, C]: per-channel sums from
    `stats` (default `group_norm_stats`), folded in fp32 to per-channel a, b,
    then y = x * a + b in x's own type (plain PyTorch), SiLU."""
    n, l, c = x.shape
    cg = c // groups
    s, ss = (stats or group_norm_stats)(x)
    sg = s.reshape(n, groups, cg).sum(dim=-1)
    ssg = ss.reshape(n, groups, cg).sum(dim=-1)
    cnt = l * cg
    mean_g = sg / cnt
    var_g = ssg / cnt - mean_g * mean_g
    inv_g = torch.rsqrt(var_g + eps)
    gamma_g = gamma.float().reshape(1, groups, cg)
    beta_g = beta.float().reshape(1, groups, cg)
    a = (gamma_g * inv_g[..., None]).reshape(n, 1, c)
    b = (beta_g - (mean_g * inv_g)[..., None] * gamma_g).reshape(n, 1, c)
    y = x * a.to(x.dtype) + b.to(x.dtype)
    if silu:
        y = y * torch.sigmoid(y)
    return y


class _GroupNormRecompute(torch.autograd.Function):
    """Backward shared by the two kernel paths: recompute through
    group_norm_xla and differentiate it (the reference's _gn_fused_bwd and
    _gn_fast_bwd)."""

    @staticmethod
    def _save(ctx, x, gamma, beta, groups, eps, silu):
        ctx.save_for_backward(x, gamma, beta)
        ctx.groups, ctx.eps, ctx.silu = groups, eps, silu

    @staticmethod
    def backward(ctx, dy):
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            y = group_norm_xla(*inputs, ctx.groups, ctx.eps, ctx.silu)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dy) if wanted else ())
        return (*(next(grads) if need else None for need in needs), None, None, None)


class _GroupNormFused(_GroupNormRecompute):
    """Forward: the K8a kernel (CUDA) or group_norm_plain (CPU)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups: int, eps: float, silu: bool):
        if _on_card_or_cpu("group_norm", x):
            y = _gn_kernel(x, gamma, beta, groups, eps, silu)
        else:
            y = group_norm_plain(x, gamma, beta, groups, eps, silu)
        _GroupNormRecompute._save(ctx, x, gamma, beta, groups, eps, silu)
        return y


class _GroupNormFast(_GroupNormRecompute):
    """Forward: group_norm_fast (the K8b kernel's sums on CUDA)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups: int, eps: float, silu: bool):
        y = group_norm_fast(x, gamma, beta, groups, eps, silu)
        _GroupNormRecompute._save(ctx, x, gamma, beta, groups, eps, silu)
        return y


def fused_group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
                     eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) of x [N, L, C] through K8a, differentiable. Launches
    the CUDA kernel for CUDA tensors and runs group_norm_plain for CPU
    tensors."""
    return _GroupNormFused.apply(x, gamma, beta, groups, float(eps), bool(silu))


fused_group_norm.launches = 0  # kernel launches since the last reset


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int = 32,
               eps: float = 1e-5, silu: bool = False, impl: Optional[str] = None) -> torch.Tensor:
    """GroupNorm(+SiLU) on x [..., L, C]; gamma, beta [C]. impl: one of
    IMPLS (see the module docstring); None reads EMOX_GROUPNORM_IMPL, unset
    meaning "xla"."""
    c = x.shape[-1]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    impl = impl or os.environ.get("EMOX_GROUPNORM_IMPL") or "xla"
    if impl not in IMPLS:
        raise ValueError("GroupNorm impl (EMOX_GROUPNORM_IMPL) must be 'xla', 'pallas', 'fast', 'pallas_interpret' "
                         f"or 'fast_interpret', got {impl!r}")
    if impl == "xla":
        return group_norm_xla(x, gamma, beta, groups, eps, silu)
    if impl == "pallas_interpret":
        return group_norm_plain(x, gamma, beta, groups, eps, silu)
    if impl == "fast_interpret":
        run = lambda x3: group_norm_fast(x3, gamma, beta, groups, eps, silu, stats=group_norm_stats_plain)
    else:
        fn = _GroupNormFused if impl == "pallas" else _GroupNormFast
        run = lambda x3: fn.apply(x3, gamma, beta, groups, float(eps), bool(silu))
    if x.dim() == 3:
        return run(x)
    shape = x.shape
    return run(x.reshape(-1, shape[-2], c)).reshape(shape)


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int = 32,
                    eps: float = 1e-5, impl: Optional[str] = None) -> torch.Tensor:
    return group_norm(x, gamma, beta, groups, eps, silu=True, impl=impl)
