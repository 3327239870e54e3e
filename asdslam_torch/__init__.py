"""asdslam_torch — the PyTorch/CUDA port of asdslam_tpu, for an NVIDIA H100.

Plain tensor code is PyTorch; the one kernel the JAX package wrote by hand
(the fused masked nearest-neighbour search) is a hand-written CUDA kernel
(``csrc/masked_nn.cu``, wrapped by ``ops/masked_nn.py``).  Module paths
mirror ``asdslam_tpu`` so each function's reference is found by path.

The entry point is ``asdslam_torch.system.System``, in the config's default
mode (pipelined tracking, the asynchronous mapping worker) or the
synchronous one.
Entry points take a ``device`` argument that defaults to ``"cuda"``.
"""

__version__ = "0.1.0"

import os as _os

# The asynchronous mapping worker runs its launches on a CUDA stream of its
# own beside the tracker's.  cuBLAS keeps results bitwise reproducible across
# concurrent streams only with a fixed workspace configuration (cuBLAS
# documentation, "Results reproducibility"); it is read when the library is
# first used, so it is set here, unless the caller chose one.
_os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch as _torch  # noqa: E402

# Geometry and estimators need true f32 products: the reference runs at
# jax_default_matmul_precision="highest" (its RANSAC fitting loses inliers to
# reduced-precision rounding).  TF32 keeps ~3 decimal digits, so it is off for
# matmuls and for cuDNN convolutions alike.  The deliberately-bf16 paths (the
# masked-NN cross term, the ASDNet convs) cast explicitly and are unaffected.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from asdslam_torch.config import SlamConfig  # noqa: E402,F401
