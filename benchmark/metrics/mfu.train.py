"""Model FLOPs of the train steps completed (forward and backward as autograd runs them for
the trainable leaves, no recomputation: benchmark/work/flops.py) over the window's seconds,
as a share of 989 TFLOP/s."""

from benchmark.harness.readers import mfu

UNIT = "%"
LAYER = "Whole request or step (model FLOPs)"
MOVES = "train_frames_per_s"
SOURCE = "host_clock"


def read(obs):
    return mfu(obs, "flops_per_step", "steps")
