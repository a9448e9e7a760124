"""slamtpu_torch — the PyTorch + CUDA port of slamtpu.

A second package beside ``slamtpu`` (the JAX reference). It carries the
lo_svn keyframe — projection, deskew, Gaussian map + RegMap build, stencil
source covariances, SVN-NDT with the plane-to-plane polish, ring insert —
with the two pair kernels (NDT and plane-to-plane) written by hand in CUDA
C++ for Hopper (``csrc/ndt_pair.cu``).

Importing the package touches no device: it initializes no CUDA context,
imports no triton and builds no kernel (kernels build at first launch).
"""

__version__ = "0.1.0"

import torch as _torch

# Full float32 everywhere: reduced-precision matmul inputs corrupt SE(3)
# chains and the 6x6 solves (slamtpu/__init__.py makes the same choice for
# its backend). Setting these flags does not initialize CUDA.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
