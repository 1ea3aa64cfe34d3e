#!/usr/bin/env python3
"""Where a float32 stage-5 step's card-against-CPU gap comes from, on one H100.

    python3 chip_probe_vae.py VAE:SIZE:IMPL [VAE:SIZE:IMPL ...]

For each case, chip_smoke.py's phase_train_step_vae without its limits: one
float32 stage-5 step (VAE pretraining, batch 1) of one of its VAE_VARIANTS
("flagship", "small", "640") at SIZE^2, on the card and on the CPU with the
same weights, images and posterior noise, TF32 off, under
EMOX_ATTENTION_IMPL=IMPL ("pallas": the mid-attention on the kernels; "xla":
plain attention on both sides). IMPL "bf16" is a control of lower precision:
"pallas" with the card's attention operands rounded to bf16 (and their
gradients rounded to bf16 on the way back), so that it shows whether an
attention of bf16 precision would stay within the phase's gradient limit.
Prints one JSON line per case: the gradients' relative L2 gap, both losses
and the eight trainable leaves with the largest gap (gap L2, CPU gradient L2,
name), so that a gap the kernels cause (it moves between pallas and xla) can
be told from one the rest of the model causes (it does not). Exits non-zero
without a card.
"""

from __future__ import annotations

import contextlib
import json
import sys
import tempfile


@contextlib.contextmanager
def bf16_attention():
    """The nn modules' attention with its card operands rounded to bf16."""
    import torch

    import emox_torch.nn.attention_blocks as blocks

    exact = blocks.dot_product_attention_nlc

    def rounded(q, k, v, *args, **kwargs):
        if q.is_cuda:
            q, k, v = (t.to(torch.bfloat16).to(t.dtype) for t in (q, k, v))
        return exact(q, k, v, *args, **kwargs)

    blocks.dot_product_attention_nlc = rounded
    try:
        yield
    finally:
        blocks.dot_product_attention_nlc = exact


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_probe_vae: no CUDA device; the probe runs on the card only", file=sys.stderr)
        return 2
    print(json.dumps({"phase": "device", "name": torch.cuda.get_device_name(0)}), flush=True)
    for case in argv or ["small:128:pallas", "small:128:bf16"]:
        vae, size, impl = case.split(":")
        control = bf16_attention() if impl == "bf16" else contextlib.nullcontext()
        with tempfile.TemporaryDirectory() as tmp, control:
            res = cs.phase_train_step_vae(tmp, int(size), vae, impl="pallas" if impl == "bf16" else impl,
                                          check=False)
        print(json.dumps({"vae": vae, "size": int(size), "impl": impl, "grads_rel_l2": res["grads_rel_l2"],
                          "loss": [res["loss_cpu"], res["loss_gpu"]], "worst_leaves": res["worst_leaves"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
