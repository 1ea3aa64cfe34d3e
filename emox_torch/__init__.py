"""emox_torch: the PyTorch + CUDA port of emox for NVIDIA Hopper (H100).

The JAX package `emox` is the reference; this package mirrors its
subpackages and names (core, data, nn, ops, models, diffusion, infer,
interop, train) and imports nothing of it. Public functions keep the reference's layouts:
images NHWC, video [B, T, H, W, C], attention tokens [N, L, H*D].

Every TPU kernel on a ported path is a CUDA kernel written for sm_90a
(emox_torch/csrc/), built with nvcc at first use and loaded with ctypes.
Each kernel's wrapper launches it for CUDA tensors and runs a plain
PyTorch version of the same function for CPU tensors. Entry points run on
the CUDA card unless given device="cpu", and raise when there is no card.

Ported so far: serving the short-clip talking-head request (EMOPipeline,
with an optional text prompt through the CLIP text encoder) and training
the denoising stages 1-3 (emox_torch.train.Trainer).
"""

__version__ = "0.1.0"
