"""conan_slam_tpu_torch: the PyTorch + CUDA port of conan_slam_tpu.

The JAX package ``conan_slam_tpu`` is the reference; this package mirrors its
module paths and holds the full-map, known-association EKF frame (the path
``bench.py`` measures) and the gated, mapping-from-scratch EKF (BASELINE
config 2) on an NVIDIA Hopper GPU.  Every kernel the JAX package
wrote in Pallas for the TPU is a hand-written CUDA kernel here
(``csrc/``), built with ``nvcc`` at first use; beside each kernel sits its
plain PyTorch version, which runs for tensors on the CPU.

It imports nothing of JAX and nothing of the JAX package: its
``config.SlamConfig`` and ``sim.precompute`` are copies of the reference's
framework-free modules, held to them by the tests.
"""

import torch

# Precision contract: every covariance product runs in full fp32.  TF32
# keeps a 10-bit mantissa; the reference measured that even a ~22-bit
# product tier flips association gates and that 16-bit split products
# detonate mapping from scratch (conan_slam_tpu/filters/ekf/update.py,
# "Gated-path precision" in PARITY.md).  PyTorch's matmul default is
# already fp32, but cuDNN's is TF32: both are pinned here, in one place.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
