"""Device operations (kernels, copies, sets) the profiler records in the traced window,
per DDIM step of the window's requests: the work the host issues for one step."""

from benchmark.harness.readers import ops_per

UNIT = "ops/step"
LAYER = "nn blocks and dispatchers (nn/, ops/)"
MOVES = "serve_frames_per_s"
SOURCE = "device_trace"


def read(obs):
    return ops_per(obs, "steps")
