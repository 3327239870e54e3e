"""Pinhole camera with radtan distortion, batched over leading dimensions.

Port of ``asdslam_tpu/geometry/camera.py``.  It mirrors the reference's
camera handling: intrinsics + (k1,k2,p1,p2) read from the camera-config txt
(src/read_write_data_lib/src/read_write.cpp:27-60); the reference undistorts
keypoints with cv::undistortPoints (Frame.cc:298-328) and full images with
cv::undistort (Tracking.cc:104).  Here: a fixed-iteration inversion for
keypoints and a bilinear remap for images.  Every function runs on its
inputs' device; the camera's fields are f32 tensors on that device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, *, device="cuda"):
        def f(v):
            return torch.tensor(float(v), dtype=torch.float32, device=device)
        return Camera(f(fx), f(fy), f(cx), f(cy), f(k1), f(k2), f(p1), f(p2))

    @property
    def K(self):
        zero, one = torch.zeros_like(self.fx), torch.ones_like(self.fx)
        return torch.stack([torch.stack([self.fx, zero, self.cx]),
                            torch.stack([zero, self.fy, self.cy]),
                            torch.stack([zero, zero, one])])


def distort_normalized(cam: Camera, xn):
    """Apply radtan to normalized coords ``xn[..., 2]``."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(cam: Camera, xd, iters: int = 8):
    """Invert radtan by fixed-point iteration (matches cv::undistortPoints)."""
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        xn = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], dim=-1)
    return xn


def pixel_to_normalized(cam: Camera, uv):
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy],
                       dim=-1)


def normalized_to_pixel(cam: Camera, xn):
    return torch.stack([xn[..., 0] * cam.fx + cam.cx, xn[..., 1] * cam.fy + cam.cy], dim=-1)


def undistort_points(cam: Camera, uv, iters: int = 8):
    """Distorted pixel coords -> undistorted pixel coords."""
    return normalized_to_pixel(cam, undistort_normalized(cam, pixel_to_normalized(cam, uv),
                                                         iters))


def project(cam: Camera, xc):
    """Camera-frame points ``xc[..., 3]`` -> pixel coords ``[..., 2]`` (no
    distortion: the reference undistorts its inputs, then treats the camera
    as an ideal pinhole downstream)."""
    z = xc[..., 2:3]
    xn = xc[..., :2] / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return normalized_to_pixel(cam, xn)


def backproject(cam: Camera, uv, depth):
    """Pixel + depth -> camera-frame 3D point."""
    xn = pixel_to_normalized(cam, uv)
    return torch.cat([xn * depth[..., None], depth[..., None]], dim=-1)


def undistort_image(cam: Camera, image):
    """Full-image undistortion by inverse-map bilinear sampling.

    ``image``: [H, W] float.  For each output pixel, distort its normalized
    coordinate to find the source pixel in the input (the semantics of
    cv::undistort / initUndistortRectifyMap with an identity new K).
    """
    H, W = image.shape
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=image.device),
                          torch.arange(W, dtype=torch.float32, device=image.device),
                          indexing="ij")
    xn = pixel_to_normalized(cam, torch.stack([u, v], dim=-1))
    return bilinear_sample(image, normalized_to_pixel(cam, distort_normalized(cam, xn)))


def bilinear_sample(image, uv):
    """Sample ``image[H, W]`` at real-valued pixel coords ``uv[..., 2]``
    (u = x, v = y)."""
    H, W = image.shape
    x = torch.clamp(uv[..., 0], 0.0, W - 1.000001)
    y = torch.clamp(uv[..., 1], 0.0, H - 1.000001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = x - x0.to(x.dtype)
    wy = y - y0.to(y.dtype)
    v00 = image[y0, x0]
    v01 = image[y0, x1]
    v10 = image[y1, x0]
    v11 = image[y1, x1]
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)
