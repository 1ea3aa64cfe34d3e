"""The hand-written kernels' sites in a request or a train step, with the work each needs.

Frozen copies of chip_smoke.py's `reader_calls`, `attn_launches_per_request`,
`ff_launches_per_request` and the stage-2 backward sites behind its `BWD_PER_STEP`, widened
from launch counts to the shapes of every site; and of its `bound()`. A site takes the
attention kernel where its key length reaches KERNEL_MIN_KV (emox_torch/ops/attention.py);
every FF sub-layer (a TransformerBlock's, a temporal transformer's) takes the FF kernel.

The work is the algorithm's: attention 4 N H Lq Lk d operations forward and 2.5 times that
backward (the flash backward recomputes the scores), the FF 24 M C^2 (LN + GEGLU, C -> 8C ->
4C -> C); bytes are each input read once and each output written once, in bfloat16.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

from benchmark.reference.emo import heads_of, vae_downscale
from benchmark.reference.sampling import windows as plan_windows

PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 tensor-core operations per second (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes per second
KERNEL_MIN_KV = 2048  # the shortest key length that takes the attention kernel
WINDOWS_PER_CALL = 4  # windows of a long clip folded into one reader call
BYTES = 2  # bfloat16


class Site(NamedTuple):
    kernel: str  # the launch counter (emox_torch.ops.launch_counts) that counts it
    count: int  # launches per request or per step
    flops: float  # per launch
    nbytes: float  # per launch

    def least_s(self) -> float:
        """The least time one launch could take on the card."""
        return bound(self.flops, self.nbytes)[0] / 1e3


def bound(flops: float, nbytes: float):
    """(least ms, what bounds it): max(operations / peak, bytes / bandwidth)."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attn_fwd(n: int, heads: int, lq: int, lk: int, d: int, count: int) -> Site:
    return Site("flash_fwd_sm90", count, 4.0 * n * heads * lq * lk * d, BYTES * n * heads * d * (2 * lq + 2 * lk))


def attn_bwd(n: int, heads: int, lq: int, lk: int, d: int, count: int) -> Site:
    # reads q, k, v, o, dO and the fp32 lse and delta rows; writes dq, dk, dv
    nbytes = BYTES * n * heads * d * (4 * lq + 4 * lk) + 8 * n * heads * lq
    return Site("flash_bwd_sm90", count, 2.5 * 4.0 * n * heads * lq * lk * d, nbytes)


def ff(m_rows: int, c: int, count: int) -> Site:
    weights = BYTES * (8 * c * c + 8 * c + 4 * c * c + c) + BYTES * 2 * c
    return Site("ff_sm90", count, 24.0 * m_rows * c * c, BYTES * 2 * m_rows * c + weights)


def attention_sites(m: dict):
    """(name, level) of every spatial transformer of a UNet in the order the forward pass
    meets them (2 lpb + 1 a level with attention, and the mid block at the deepest level),
    and the widths of the levels."""
    chans = [m["base_channels"] * k for k in m["channel_multipliers"]]
    levels = [lv for lv in range(len(chans)) if lv in m["attention_levels"]]
    sites = [(f"down_{lv}_{i}", lv) for lv in levels for i in range(m["layers_per_block"])]
    sites.append(("mid", len(chans) - 1))
    sites += [(f"up_{lv}_{i}", lv) for lv in reversed(levels) for i in range(m["layers_per_block"] + 1)]
    return sites, chans


def reader_calls(cfg: dict, steps: int, frames: int) -> List[int]:
    """The windows of each reader call of one request: one call a step for a clip of one
    window, else per step one call per WINDOWS_PER_CALL windows of the step's plan."""
    inf = cfg["inference"]
    if frames <= inf["context_frames"]:
        return [1] * steps
    calls = []
    for s in range(steps):
        n = len(plan_windows(s, frames, inf["context_frames"], inf["context_stride"], inf["context_overlap"]))
        calls += [min(WINDOWS_PER_CALL, n - i) for i in range(0, n, WINDOWS_PER_CALL)]
    return calls


def request_sites(cfg: dict, size: int, frames: int, steps: int) -> List[Site]:
    """The attention-forward and FF kernel sites of one CFG-batched serving request."""
    m, v = cfg["model"], cfg["vae"]
    lat = size // vae_downscale(v)
    clip = min(frames, cfg["inference"]["context_frames"])
    sites, chans = attention_sites(m)
    out: List[Site] = []
    calls = reader_calls(cfg, steps, frames)
    for _, level in sites:
        c = chans[level]
        heads, d = heads_of(m, c)
        tokens = (lat >> level) ** 2
        if tokens >= KERNEL_MIN_KV:  # the writer: one pass over every step's timestep
            out.append(attn_fwd(steps, heads, tokens, tokens, d, 1))
        out.append(ff(steps * tokens, c, 1))
        for w in sorted(set(calls)):
            rows = 2 * w * clip  # CFG halves x windows x frames
            n_calls = calls.count(w)
            if 2 * tokens >= KERNEL_MIN_KV:
                out.append(attn_fwd(rows, heads, tokens, 2 * tokens, d, n_calls))
            out.append(ff(rows * tokens, c, n_calls * (2 if m["use_temporal"] else 1)))
    if lat * lat >= KERNEL_MIN_KV:  # the VAE's mid attention: encode the reference, decode the clip
        d = v["base_channels"] * v["channel_multipliers"][-1]
        out.append(attn_fwd(1, 1, lat * lat, lat * lat, d, 1))
        out.append(attn_fwd(frames, 1, lat * lat, lat * lat, d, 1))
    return out


def stage2_bwd_sites(cfg: dict, size: int, batch: int, frames: int) -> List[Site]:
    """The attention-backward sites of one stage-2 step: every reader site that takes the
    kernel and whose output carries a gradient, that is all but the first (no trained
    parameter precedes it)."""
    m = cfg["model"]
    lat = size // vae_downscale(cfg["vae"])
    sites, chans = attention_sites(m)
    out = []
    for name, level in sites[1:]:
        heads, d = heads_of(m, chans[level])
        tokens = (lat >> level) ** 2
        if 2 * tokens >= KERNEL_MIN_KV:
            out.append(attn_bwd(batch * frames, heads, tokens, 2 * tokens, d, 1))
    return out


def expected_launches(sites: List[Site]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for s in sites:
        counts[s.kernel] = counts.get(s.kernel, 0) + s.count
    return counts
