"""Model FLOPs of the requests completed (the reference's matmuls, convolutions and attention
at the cell's shapes, counted on the meta device: benchmark/work/flops.py) over the window's
seconds, as a share of 989 TFLOP/s (H100 SXM dense bf16)."""

from benchmark.harness.readers import mfu

UNIT = "%"
LAYER = "Whole request or step (model FLOPs)"
MOVES = "serve_frames_per_s"
SOURCE = "host_clock"


def read(obs):
    return mfu(obs, "flops_per_request", "requests")
