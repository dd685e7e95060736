"""equidock_public_tpu_torch: the PyTorch + CUDA port of equidock_public_tpu.

The JAX package stays the reference; this package keeps its module names and
its batch layout so each module's counterpart is easy to find and the tests
can hold one against the other. It imports torch, numpy, the standard
library and, for a training sample's random pose, scipy. Hand-written CUDA
kernels for NVIDIA Hopper (sm_90a) replace the Pallas TPU kernels on the
serving and training paths; every kernel has a plain PyTorch version beside
it, which is what runs when the tensors lie on the CPU.
"""

__version__ = "0.1.0"
