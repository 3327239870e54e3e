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

Training form (``ASDNetTrain``): the reference ``apply(train=True,
batch_stats=True, compute_dtype=f32)``: f32 convs (TF32 stays off, as the
package sets it), BN over the batch's own biased statistics, dropout with
keep 0.7 after layer 5's ReLU, and the running statistics updated from the
anchor pass by ``update_running_stats``.  ``save_weights`` writes the
reference's pickle (convs HWIO), which both packages' ``run_slam`` read.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Sequence

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
DROPOUT_KEEP = 0.7


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
        for i in range(len(LAYERS)):
            x = _layer_conv(x, getattr(self, f"conv{i}").to(compute_dtype), i)
            x = x * getattr(self, f"scale{i}")[:, None, None] + getattr(self, f"shift{i}")[:, None, None]
            if i < len(LAYERS) - 1:
                x = torch.relu(x)
            x = x.to(compute_dtype)
        return _l2_normalise(x)


def _layer_conv(x, w, i):
    """Layer i's conv with the reference's padding: "SAME" pads the stride-2
    3x3 convs (0, 1), the others (1, 1); the 8x8 conv is "VALID"."""
    ks, _cin, _cout, stride = LAYERS[i]
    if stride == 2:
        x = F.pad(x, (0, 1, 0, 1))
        padding = 0
    else:
        padding = 0 if ks == 8 else 1
    return _conv_f32_out(x, w, stride, padding)


def _l2_normalise(x):
    d = x.reshape(x.shape[0], -1).to(torch.float32)
    return d / torch.sqrt(torch.sum(d * d, dim=1, keepdim=True) + 1e-10)


# --------------------------------------------------------------------------- #
# Training form
# --------------------------------------------------------------------------- #
def _orthogonal(seed: int, shape, gain: float) -> np.ndarray:
    """Orthogonal init over the (fan_in, fan_out) flattening of an HWIO
    ``shape``, the reference's ``_orthogonal`` given its integer seed: numpy
    QR of a ``default_rng(seed)`` normal draw, columns sign-fixed by R's
    diagonal, times ``gain``.  Returns the HWIO array in f32."""
    fan_out = shape[-1]
    fan_in = int(np.prod(shape[:-1]))
    n, m = max(fan_in, fan_out), min(fan_in, fan_out)
    a = np.random.default_rng(int(seed)).standard_normal((n, m))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diagonal(r))
    w = q if fan_in >= fan_out else q.T
    return np.asarray((gain * w).reshape(shape), np.float32)


def draw_init_seeds(generator: torch.Generator) -> List[int]:
    """One integer seed per layer for ``init_params``, from a CPU generator
    (the reference takes them from split JAX keys)."""
    return [int(s) for s in torch.randint(0, 2 ** 32, (len(LAYERS),), generator=generator,
                                          dtype=torch.int64)]


def init_params(seeds: Sequence[int]) -> Dict[str, List[np.ndarray]]:
    """Fresh parameters in the reference's layout: ``conv`` HWIO f32 arrays
    from ``_orthogonal`` (gain 0.6), ``bn_mean`` zeros, ``bn_var`` ones."""
    return {
        "conv": [_orthogonal(seed, (ks, ks, cin, cout), gain=0.6)
                 for seed, (ks, cin, cout, _s) in zip(seeds, LAYERS)],
        "bn_mean": [np.zeros((cout,), np.float32) for _ks, _cin, cout, _s in LAYERS],
        "bn_var": [np.ones((cout,), np.float32) for _ks, _cin, cout, _s in LAYERS],
    }


def draw_dropout_mask(generator: torch.Generator, n: int) -> torch.Tensor:
    """The keep mask of the dropout before the last conv, on the
    generator's device: [n, 128, 8, 8] bool, each entry kept with
    probability 0.7 (the reference draws it in NHWC, [n, 8, 8, 128]; a
    replayed mask is transposed to NCHW)."""
    u = torch.rand((n, LAYERS[-1][1], 8, 8), generator=generator, device=generator.device)
    return u < DROPOUT_KEEP


class ASDNetTrain(nn.Module):
    """Trainable ASDNet: ``conv`` the seven OIHW weights as parameters,
    ``bn_mean{i}`` / ``bn_var{i}`` the running statistics as buffers.
    Built from parameters in the reference's layout (``init_params``, or a
    reference pickle's dict)."""

    def __init__(self, params: Dict[str, Any]):
        super().__init__()
        self.conv = nn.ParameterList(
            nn.Parameter(torch.tensor(np.asarray(w, np.float32)).permute(3, 2, 0, 1).contiguous())
            for w in params["conv"])
        for i in range(len(LAYERS)):
            self.register_buffer(f"bn_mean{i}", torch.tensor(np.asarray(params["bn_mean"][i], np.float32)))
            self.register_buffer(f"bn_var{i}", torch.tensor(np.asarray(params["bn_var"][i], np.float32)))

    def forward(self, patches: torch.Tensor, train: bool = True, dropout_mask=None,
                generator=None):
        """patches [N, 32, 32] in [0, 1] -> (descriptors [N, 128] f32,
        L2-normalised, (batch means, batch variances) of the seven layers).

        ``train``: BN over the batch's biased statistics and dropout before
        the last conv, with ``dropout_mask`` ([N, 128, 8, 8] bool) or one
        drawn from ``generator``; otherwise the running statistics, no
        dropout, and no statistics returned (empty lists)."""
        x = input_norm(patches[:, None].to(torch.float32))
        means, variances = [], []
        for i in range(len(LAYERS)):
            x = _layer_conv(x, self.conv[i], i)
            if train:
                mean = x.mean(dim=(0, 2, 3))
                var = x.var(dim=(0, 2, 3), correction=0)
                means.append(mean.detach())
                variances.append(var.detach())
            else:
                mean, var = getattr(self, f"bn_mean{i}"), getattr(self, f"bn_var{i}")
            x = (x - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]
            if i < len(LAYERS) - 1:
                x = torch.relu(x)
            if train and i == len(LAYERS) - 2:
                if dropout_mask is None:
                    dropout_mask = draw_dropout_mask(generator, x.shape[0]).to(x.device)
                x = torch.where(dropout_mask, x / DROPOUT_KEEP, torch.zeros_like(x))
        return _l2_normalise(x), (means, variances)

    @torch.no_grad()
    def update_running_stats(self, stats, momentum: float = 0.1):
        """running = (1 - momentum) * running + momentum * batch, per layer,
        in place: a captured training step writes the buffers the module
        holds."""
        for i, (bm, bv) in enumerate(zip(*stats)):
            for name, b in ((f"bn_mean{i}", bm), (f"bn_var{i}", bv)):
                getattr(self, name).mul_(1 - momentum).add_(momentum * b)

    def params_to_jax(self) -> Dict[str, List[np.ndarray]]:
        """The parameters in the reference's layout, keys in the order
        ``jax.device_get`` writes them: f32 numpy lists, convs HWIO (the
        inverse of ``params_from_jax`` before its BN folding)."""
        def host(t):
            return np.array(t.detach().cpu().numpy(), np.float32)

        return {
            "bn_mean": [host(getattr(self, f"bn_mean{i}")) for i in range(len(LAYERS))],
            "bn_var": [host(getattr(self, f"bn_var{i}")) for i in range(len(LAYERS))],
            "conv": [host(w.permute(2, 3, 1, 0).contiguous()) for w in self.conv],
        }

    def inference_state(self) -> Dict[str, torch.Tensor]:
        """An ``ASDNet`` state dict of these weights (BN folded)."""
        return params_from_jax(self.params_to_jax())

    def save_weights(self, path):
        """Write the reference's weights pickle (``pickle.dump(jax.device_get(
        params))``'s bytes for the same values): ``run_slam.py`` and
        ``run_slam_torch.py`` read it with ``--asdnet_weights``."""
        with open(path, "wb") as f:
            pickle.dump(self.params_to_jax(), f)


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
