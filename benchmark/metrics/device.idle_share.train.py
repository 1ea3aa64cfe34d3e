"""The share of the traced window in which no operation ran on the device."""

from benchmark.harness.readers import idle_share

UNIT = "%"
LAYER = "Device"
MOVES = "train_frames_per_s"
SOURCE = "device_trace"


def read(obs):
    return idle_share(obs)
