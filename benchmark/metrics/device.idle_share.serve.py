"""The share of the traced window in which no operation ran on the device: 1 - the union
of the device events' intervals over the window."""

from benchmark.harness.readers import idle_share

UNIT = "%"
LAYER = "Device"
MOVES = "serve_frames_per_s"
SOURCE = "device_trace"


def read(obs):
    return idle_share(obs)
