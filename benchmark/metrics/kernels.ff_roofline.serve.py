"""ff_sm90.cu's share of its roofline: the least time of the window's FF sub-layers (LN +
GEGLU, 24 M C^2 operations, x read and y written once, the weights read once a call) over
the device time of its GEMMs, its LN pass and its split sums."""

from benchmark.harness.readers import roofline

KERNEL = "ff_sm90"
INCLUDE = ("emox::ff_sm90::", "emox::gemm_sm90::ln_rows_kernel<__nv_bfloat16")
EXCLUDE = ()

UNIT = "%"
LAYER = "Kernels (emox_torch/csrc)"
MOVES = "serve_frames_per_s"
SOURCE = "device_trace"


def read(obs):
    return roofline(obs, KERNEL, INCLUDE, EXCLUDE, "requests")
