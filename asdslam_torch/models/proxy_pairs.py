"""Descriptor-training patch pairs from the KITTI proxy world.

Port of ``asdslam_tpu/models/proxy_pairs.py``.  The reference trains ASDNet
on UBC PhotoTour patch pairs (ASDNet.py:119-195), which are not available
offline.  This source renders two frames a few metres apart along the real
KITTI trajectory (``io/kitti_proxy.py``), takes the renderer's exact
per-pixel depth to establish ground-truth correspondence (the world point
of a pixel in frame i projected into frame j, with an occlusion check
against frame j's depth), and cuts matched 32x32 patches: pairs with real
viewpoint, scale and perspective change.

The frames render in torch on ``device``; the sampling is numpy
(``default_rng(seed)``), the reference's, so given the renderer's parity the
pairs are the reference's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from asdslam_torch.io import kitti_proxy
from asdslam_torch.mapping.map_store import _pose_np


class ProxyPairSource:
    def __init__(self, seq: str = "00", scale: float = 1.0, n_boxes: int = 256,
                 patch: int = 32, seed: int = 5, device="cuda"):
        self.seq = kitti_proxy.KittiProxySequence(seq, scale=scale, n_boxes=n_boxes,
                                                 device=device)
        self.patch = patch
        self.rng = np.random.default_rng(seed)
        self.K_np = self.seq.K.cpu().numpy()

    def _render(self, i):
        s = self.seq
        w = kitti_proxy.select_boxes(s.world, s.centers[i], s.n_boxes)
        img, depth = kitti_proxy.render_boxes(
            torch.as_tensor(s.gt_pose7[i]).to(s.device), s.K, w.bmin, w.bmax, w.salt,
            s.height, s.width, return_depth=True)
        return img.cpu().numpy(), depth.cpu().numpy()

    def sample(self, batch: int, max_delta: int = 6,
               per_frame_cap: int = 200) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (anchors [B, 32, 32], positives [B, 32, 32]) float32.

        per_frame_cap bounds the pairs taken from one rendered frame pair, so
        that a large pool spans many viewpoints along the trajectory."""
        s = self.seq
        ps = self.patch
        half = ps // 2
        out_a = np.zeros((batch, ps, ps), np.float32)
        out_p = np.zeros((batch, ps, ps), np.float32)
        n = 0
        while n < batch:
            i = int(self.rng.integers(0, len(s) - max_delta - 1))
            j = i + int(self.rng.integers(1, max_delta + 1))
            img_i, dep_i = self._render(i)
            img_j, dep_j = self._render(j)
            H, W = img_i.shape
            Ri, ti = _pose_np(s.gt_pose7[i])
            Rj, tj = _pose_np(s.gt_pose7[j])
            ci = -Ri.T @ ti

            # candidate pixels: textured (non-sky), inside margins
            m = half + 2
            vv, uu = np.mgrid[m:H - m, m:W - m]
            vv, uu = vv.ravel(), uu.ravel()
            d = dep_i[vv, uu]
            ok = d < 1e7
            vv, uu, d = vv[ok], uu[ok], d[ok]
            if len(vv) == 0:
                continue
            want = min(per_frame_cap, batch - n)
            sel = self.rng.choice(len(vv), min(4 * want, len(vv)), replace=False)
            vv, uu, d = vv[sel], uu[sel], d[sel]

            # world point: ray with z-normalized direction, t = z-depth
            xn = (uu - self.K_np[0, 2]) / self.K_np[0, 0]
            yn = (vv - self.K_np[1, 2]) / self.K_np[1, 1]
            d_cam = np.stack([xn, yn, np.ones_like(xn)], 1)
            d_w = d_cam @ Ri  # R^T d
            P = ci[None, :] + d[:, None] * d_w

            # project into frame j + occlusion check
            xc = P @ Rj.T + tj
            z = xc[:, 2]
            good = z > 0.5
            uj = self.K_np[0, 0] * xc[:, 0] / np.maximum(z, 1e-6) + self.K_np[0, 2]
            vj = self.K_np[1, 1] * xc[:, 1] / np.maximum(z, 1e-6) + self.K_np[1, 2]
            good &= (uj >= m) & (uj < W - m) & (vj >= m) & (vj < H - m)
            uji = np.clip(np.round(uj).astype(int), 0, W - 1)
            vji = np.clip(np.round(vj).astype(int), 0, H - 1)
            good &= np.abs(dep_j[vji, uji] - z) < 0.5

            taken = 0
            for a in np.nonzero(good)[0]:
                if n >= batch or taken >= per_frame_cap:
                    break
                taken += 1
                y0, x0 = vv[a] - half, uu[a] - half
                y1, x1 = vji[a] - half, uji[a] - half
                out_a[n] = img_i[y0:y0 + ps, x0:x0 + ps]
                out_p[n] = img_j[y1:y1 + ps, x1:x1 + ps]
                n += 1
        return out_a, out_p
