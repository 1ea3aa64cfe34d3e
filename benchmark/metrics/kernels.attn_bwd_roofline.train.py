"""flash_bwd_sm90.cu's share of its roofline: the least time of a train step's attention
backward sites (2.5 x the forward's 4 N H Lq Lk d operations; q k v o dO read, dq dk dv
written once), times the steps, over the device time of its dq and dk/dv kernels."""

from benchmark.harness.readers import roofline

KERNEL = "flash_bwd_sm90"
INCLUDE = ("emox::bwd_sm90::",)
EXCLUDE = ()

UNIT = "%"
LAYER = "Kernels (emox_torch/csrc)"
MOVES = "train_frames_per_s"
SOURCE = "device_trace"


def read(obs):
    return roofline(obs, KERNEL, INCLUDE, EXCLUDE, "steps")
