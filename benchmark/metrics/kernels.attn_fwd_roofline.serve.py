"""flash_fwd_sm90.cu's share of its roofline: the least time of the window's attention-forward
sites (benchmark/work/sites.py: 4 N H Lq Lk d operations, q k v read and o written once, at
989 TFLOP/s and 3.35 TB/s) over the device time of the kernels named below."""

from benchmark.harness.readers import roofline

KERNEL = "flash_fwd_sm90"  # the launch counter the site list is held to
INCLUDE = ("emox::sm90::fwd",)
EXCLUDE = ()

UNIT = "%"
LAYER = "Kernels (emox_torch/csrc)"
MOVES = "serve_frames_per_s"
SOURCE = "device_trace"


def read(obs):
    return roofline(obs, KERNEL, INCLUDE, EXCLUDE, "requests")
