"""torch.cuda.max_memory_allocated() over the window (reset at its start), in GB."""

from benchmark.harness.readers import peak_gb

UNIT = "GB"
LAYER = "Device"
MOVES = "train_frames_per_s"
SOURCE = "program_counter"


def read(obs):
    return peak_gb(obs)
