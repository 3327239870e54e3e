"""Frame feature extraction: pyramid -> FAST -> orientation -> patches ->
descriptors.

Port of ``asdslam_tpu/frontend/extractor.py`` (ORBextractor::ExtractDesc,
ORBextractor.cc:1137-1248): 8-level x1.2 pyramid, per-level FAST with cell
fallback thresholds, intensity-centroid orientation, then the descriptor on
32x32 patches of the Gaussian-blurred level, one batch over all levels: the
ASD CNN on upright patches, or the ORB embedding on patches derotated by
the keypoint angle.  Per-level budgets follow the reference's geometric
allocation (nfeatures * (1-q)/(1-q^L) * q^level with q = 1/scale_factor).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from asdslam_torch.config import SlamConfig
from asdslam_torch.geometry import camera as camera_mod
from asdslam_torch.ops import fast, patches, pyramid
from asdslam_torch.utils import graphs, tracing
from asdslam_torch.utils.batching import sequential


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame feature set (capacity = cfg.n_features).

    uv:      [N, 2] keypoint positions in level-0 (full-res) pixel coords
    uv_und:  [N, 2] undistorted positions (= uv when distortion-free)
    level:   [N]    pyramid level (int32)
    angle:   [N]    orientation in radians
    score:   [N]    detector response
    desc:    [N, D] L2-normalized descriptors (float32)
    valid:   [N]    validity mask
    """

    uv: torch.Tensor
    uv_und: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    score: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor


def level_budgets(cfg: SlamConfig) -> List[int]:
    q = 1.0 / cfg.scale_factor
    total = cfg.n_features
    raw = [total * (1 - q) / (1 - q ** cfg.n_levels) * (q ** i) for i in range(cfg.n_levels)]
    budgets = [max(8, int(round(r))) for r in raw]
    budgets[0] += total - sum(budgets)  # force the exact sum
    return budgets


def make_extractor(cfg: SlamConfig, descriptor_fn, rotate_patches: bool = False):
    """Build the extractor: image [H, W] float32 in [0, 1] -> FrameFeatures,
    on the image's device.

    descriptor_fn: (patches [N, 32, 32]) -> [N, D] descriptors, e.g. an
    ``ASDNet`` moved to the device, or ``ops.orb.apply``.
    rotate_patches: derotate patches by the keypoint angle before the
    descriptor (the ORB path; ASD patches stay upright like the reference's
    computeSIFTDescriptors crop).
    On a CUDA image the extractor is replayed from a CUDA graph
    (``utils/graphs.py``, the reference's ``jax.jit``); ``.eager`` is the
    function itself, which a CPU image runs.
    """
    budgets = level_budgets(cfg)
    scales = cfg.scale_factors
    # one descriptor call per sequence in the batched tracking step: its
    # convolutions' algorithms are picked by batch size (utils/batching.py)
    describe = sequential(descriptor_fn, f"descriptor:{id(descriptor_fn)}")

    def extract(image: torch.Tensor) -> FrameFeatures:
        levels = pyramid.build_pyramid(image, cfg.n_levels, cfg.scale_factor)
        all_uv, all_lvl, all_ang, all_score, all_valid, all_pat = [], [], [], [], [], []
        for li, img_l in enumerate(levels):
            # thresholds are on [0,1] images; the reference's 20/7 are on [0,255]
            xy, score, valid = fast.detect_level(
                img_l,
                threshold=cfg.fast_threshold / 255.0,
                min_threshold=cfg.fast_min_threshold / 255.0,
                max_keypoints=budgets[li],
                cell_size=cfg.cell_size,
                cell_cap=cfg.cell_cap,
                border=cfg.edge_margin,
            )
            ang = patches.ic_angle(img_l, xy, radius=cfg.orientation_radius)
            blurred = pyramid.gaussian_blur(img_l)
            if rotate_patches:
                pat = patches.extract_rotated_patches(blurred, xy, ang, size=cfg.patch_size)
            else:
                pat = patches.extract_patches(blurred, xy, size=cfg.patch_size)
            all_ang.append(ang)
            all_pat.append(pat)
            all_uv.append(xy * scales[li])
            all_lvl.append(torch.full((budgets[li],), li, dtype=torch.int32,
                                      device=image.device))
            all_score.append(score)
            all_valid.append(valid)

        uv = torch.cat(all_uv, dim=0)
        valid = torch.cat(all_valid, dim=0)
        pat = torch.cat(all_pat, dim=0)
        tracing.stage("patches")  # the stage clock of a stamped step
        desc = describe(pat)
        desc = torch.where(valid[:, None], desc, torch.zeros_like(desc))
        tracing.stage("described")
        return FrameFeatures(
            uv=uv, uv_und=uv, level=torch.cat(all_lvl, dim=0),
            angle=torch.cat(all_ang, dim=0), score=torch.cat(all_score, dim=0),
            desc=desc, valid=valid,
        )

    return graphs.captured(extract, "extract")


def with_undistortion(extract_fn, cam):
    """Wrap an extractor to fill uv_und through the camera model
    (Frame.cc:298-328): the radtan inverse of ``uv`` on valid rows, ``uv``
    elsewhere.  ``cam`` (geometry/camera.py) lives on the extractor's device:
    the wrapper uploads nothing and reads nothing back.  Captured as
    ``make_extractor``'s extractor is (the inner extractor runs inside this
    graph)."""
    def run(image):
        f = extract_fn(image)
        und = camera_mod.undistort_points(cam, f.uv)
        return f._replace(uv_und=torch.where(f.valid[:, None], und, f.uv))

    return graphs.captured(run, "extract_undistorted")
