"""ASDNet — the learned 128-float patch descriptor, as a torch module.

Port of the inference path of ``asdslam_tpu/models/asdnet.py`` (itself the
reference's L2-Net/HardNet tower, ASDNet/ASDNet/ASDNet.py:331-370) on
1x32x32 patches:

    conv3x3(1->32)    BN ReLU        conv3x3(32->32)   BN ReLU
    conv3x3(32->64,s2) BN ReLU       conv3x3(64->64)   BN ReLU
    conv3x3(64->128,s2) BN ReLU      conv3x3(128->128) BN ReLU
    conv8x8(128->128, valid) BN  -> flatten, L2-normalise

with per-patch input whitening (mean, unbiased std + 1e-7).  BN is the
inference form: running stats folded into a per-channel scale and shift
(eps 1e-5).

Layout: the public input is [N, 32, 32] as in the reference; inside, NCHW.
The reference's "SAME" padding on the stride-2 3x3 convs pads (0, 1), not
(1, 1), so those layers pad explicitly.  Weights convert from the reference's
HWIO only at ``params_from_jax``.

Numerics: ``compute_dtype`` plays the role of the reference ``apply``'s: the
convs run in it (bf16 by default), the BN and ReLU in f32, and the activation
is cast back to ``compute_dtype`` after every layer, the last one included.
Each conv takes compute-dtype operands and returns f32, as the reference's
does (``preferred_element_type=f32``), so nothing is rounded before the BN.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# (kernel_hw, in_ch, out_ch, stride)
LAYERS = [
    (3, 1, 32, 1),
    (3, 32, 32, 1),
    (3, 32, 64, 2),
    (3, 64, 64, 1),
    (3, 64, 128, 2),
    (3, 128, 128, 1),
    (8, 128, 128, 1),  # valid padding: 8x8 -> 1x1
]

DESC_DIM = 128
BN_EPS = 1e-5


def input_norm(x):
    """Per-patch whitening over all pixels of each patch. x: [N, 1, H, W]."""
    flat = x.reshape(x.shape[0], -1)
    n = flat.shape[1]
    mean = flat.mean(dim=1)
    var = flat.var(dim=1, correction=0) * (n / (n - 1))  # torch.std's unbiased form
    std = torch.sqrt(var) + 1e-7
    return (x - mean[:, None, None, None]) / std[:, None, None, None]


def _conv_f32_out(x, w, stride, padding):
    """conv2d of x and w (each already in the compute dtype) with an f32
    result, as the reference's conv with ``preferred_element_type=f32``: the
    operands are widened to f32 and the conv runs in f32, so the output is
    never rounded to bf16.  On a CUDA device the conv runs with TF32 allowed
    (the package turns it off globally): a bf16 value is exact in TF32 (10
    mantissa bits to bf16's 7), so every product stays exact and the sums
    stay f32, at the TF32 rate instead of cuDNN's far slower full-f32 path.
    An f32 compute dtype keeps TF32 off."""
    narrow = w.dtype in (torch.bfloat16, torch.float16)
    x, w = x.to(torch.float32), w.to(torch.float32)
    if not (x.is_cuda and narrow):
        return F.conv2d(x, w, stride=stride, padding=padding)
    # only this flag changes (cudnn.flags() would also reset the others)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        return F.conv2d(x, w, stride=stride, padding=padding)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class ASDNet(nn.Module):
    """Inference-only ASDNet.  Buffers: ``conv{i}`` OIHW weights,
    ``scale{i}``/``shift{i}`` the folded BN of layer i."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        for i, (ks, cin, cout, _s) in enumerate(LAYERS):
            # random weights from a fixed seed until trained ones are loaded
            w = torch.randn(cout, cin, ks, ks, generator=g) * (0.6 / (cin * ks * ks) ** 0.5)
            self.register_buffer(f"conv{i}", w)
            self.register_buffer(f"scale{i}", torch.full((cout,), (1.0 + BN_EPS) ** -0.5))
            self.register_buffer(f"shift{i}", torch.zeros(cout))

    def forward(self, patches: torch.Tensor, compute_dtype=torch.bfloat16):
        """patches [N, 32, 32] in [0, 1] -> descriptors [N, 128] float32,
        L2-normalised."""
        x = input_norm(patches[:, None].to(torch.float32)).to(compute_dtype)
        for i, (ks, _cin, _cout, stride) in enumerate(LAYERS):
            if stride == 2:
                x = F.pad(x, (0, 1, 0, 1))
                padding = 0
            else:
                padding = 0 if ks == 8 else 1
            w = getattr(self, f"conv{i}").to(compute_dtype)
            x = _conv_f32_out(x, w, stride, padding)
            x = x * getattr(self, f"scale{i}")[:, None, None] + getattr(self, f"shift{i}")[:, None, None]
            if i < len(LAYERS) - 1:
                x = torch.relu(x)
            x = x.to(compute_dtype)
        d = x.reshape(x.shape[0], -1).to(torch.float32)
        return d / torch.sqrt(torch.sum(d * d, dim=1, keepdim=True) + 1e-10)


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference params (``conv`` HWIO, ``bn_mean``, ``bn_var`` lists of
    arrays) -> an ``ASDNet`` state dict (OIHW, BN folded)."""
    sd = {}
    for i in range(len(LAYERS)):
        w = np.asarray(params["conv"][i], np.float32)
        mean = torch.tensor(np.asarray(params["bn_mean"][i], np.float32))
        var = torch.tensor(np.asarray(params["bn_var"][i], np.float32))
        scale = torch.rsqrt(var + BN_EPS)
        sd[f"conv{i}"] = torch.tensor(w).permute(3, 2, 0, 1).contiguous()
        sd[f"scale{i}"] = scale
        sd[f"shift{i}"] = -mean * scale
    return sd


class _ArrayUnpickler(pickle.Unpickler):
    """Unpickles plain numpy arrays and nothing else."""

    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "_reconstruct")}

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(f"{module}.{name} is not a numpy array type")
        if name == "_reconstruct":  # numpy 1.x names its core module `core`
            return np.ndarray.__reduce__(np.zeros(0))[0]
        return getattr(np, name)


def load_weights(path) -> Dict[str, torch.Tensor]:
    """Read a reference weights pickle (``asdnet_weights.pkl``: a dict of
    lists of numpy arrays) -> an ``ASDNet`` state dict."""
    with open(path, "rb") as f:
        params = _ArrayUnpickler(f).load()
    return params_from_jax(params)
