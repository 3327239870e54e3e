"""Single configuration dataclass carrying every behavioural threshold.

The port's own copy of ``asdslam_tpu.config.SlamConfig``: same fields, same
defaults, same derived properties, so one set of keyword arguments builds
both and the thresholds stay the algorithm's.  The port imports nothing of
the JAX package, hence the copy.

The reference system (ASD-SLAM) spreads its "magic numbers" across gflags and
hard-coded constants; they ARE the algorithm, so we catalogue them here in one
place.  Each field cites the reference location it mirrors.

Static capacities (``max_*``) keep every device block at a fixed shape with a
validity mask.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    # ------------------------------------------------------------------ #
    # Feature extraction (ref: src/vslam/src/ORBextractor.cc, Tracking.cc:80-81,
    # run_vslam_kitti.sh flags --feature_count/--feature_scale_factor/--feature_level)
    # ------------------------------------------------------------------ #
    n_features: int = 2000            # --feature_count
    n_levels: int = 8                 # --feature_level
    scale_factor: float = 1.2         # --feature_scale_factor
    fast_threshold: float = 20.0      # iniThFAST (ORBextractor.cc:817-864)
    fast_min_threshold: float = 7.0   # minThFAST fallback when a cell is empty
    fast_arc_length: int = 9          # FAST-9 contiguous-arc criterion
    cell_size: int = 30               # 30-px detection cells (ORBextractor.cc:~830)
    cell_cap: int = 4                 # top-k corners kept per detection cell
    #                                   (replaces the quadtree's spatial cap)
    edge_margin: int = 19             # border margin for patch/descriptor validity
    patch_size: int = 32              # descriptor patch (ASD input, 32x32)
    orientation_radius: int = 15      # IC_Angle half patch (ORBextractor.cc:80-107)

    # Descriptor type: 128-float ASD (learned) or 256-bit ORB (use_orb flag)
    use_orb: bool = False             # --use_orb
    descriptor_dim: int = 128         # ASD output dim (ASDNet.py:331-370)
    # Ship map-point descriptors to the device as bf16 (halves the dominant
    # KF-rate upload; the MXU matmul computes in bf16 either way).  Toggle
    # for A/B attribution of association-quality effects.
    desc_upload_bf16: bool = True
    # Fused masked-NN matcher for the hot projection searches: on a CUDA
    # device the hand-written kernel of ops/masked_nn.py, which never writes
    # the [N, M] distance matrix; False takes the plain distance-matrix path.
    # (Name kept from the reference config so both build from one kwargs set.)
    use_pallas_match: bool = True

    # ------------------------------------------------------------------ #
    # Pipelined execution (additions with no reference counterpart —
    # the reference is fully synchronous).  Both knobs preserve determinism:
    # all orchestration decisions depend only on frame ids and kernel
    # results, never on wall-clock.
    # ------------------------------------------------------------------ #
    # Dispatch frame t+1's fused kernel BEFORE syncing frame t's result:
    # the host decodes/bookkeeps frame t while t+1 executes, hiding the
    # device-round-trip latency.  The device-state recurrence (pose, velocity, features, geom,
    # crow) makes the speculative dispatch exact; a gate failure at frame t
    # discards t+1's speculative result (its extracted features are reused).
    pipelined_tracking: bool = True
    # Run the per-keyframe mapping pass (triangulate/fuse/local BA/loop
    # detect) in a worker thread while tracking continues against the
    # frozen pre-KF device blocks.  The join point is DETERMINISTIC: results
    # are applied when the tracker processes the keyframe's frame id +
    # mapping_overlap_frames (or at the next KF / staged fallback, whichever
    # first) — never "when the thread happens to finish".
    async_mapping: bool = True
    mapping_overlap_frames: int = 6

    # ------------------------------------------------------------------ #
    # Matching (ref: src/vslam/src/ORBmatcher.cc:37-39)
    # ------------------------------------------------------------------ #
    match_th_high: float = 1.5        # TH_HIGH — squared-L2 on unit descriptors
    match_th_low: float = 0.5         # TH_LOW
    match_nn_ratio_track: float = 0.9  # mfNNratio for tracking matchers
    match_nn_ratio_loop: float = 0.85  # ratio used in loop closing SearchByBoW
    histo_length: int = 30            # rotation-consistency histogram bins
    check_orientation: bool = True
    search_radius_motion: float = 15.0  # SearchByProjection th (Tracking.cc:679)
    search_radius_motion_wide: float = 30.0  # widened retry (<20 matches, Tracking.cc:681-685)
    search_radius_local: float = 4.0    # TrackLocalMap SearchByProjection
    #                                     radius factor (th=1 * r=4.0 per
    #                                     predicted level, ORBmatcher.cc:60-70)
    min_refkf_matches: int = 15         # TrackReferenceKeyFrame match gate
    #                                     (Tracking.cc:625) — also the reloc
    #                                     per-candidate gate (Tracking.cc:1150)
    min_motion_matches: int = 20        # retry gate for motion model matcher
    min_track_matches: int = 10         # TrackWithMotionModel/RefKF success gate
    min_localmap_matches: int = 30      # TrackLocalMap success gate

    # ------------------------------------------------------------------ #
    # Tracking / keyframe policy (ref: Tracking.cc:39-45, 770-779)
    # ------------------------------------------------------------------ #
    min_match_count: int = 100        # --min_match_count: new KF if inliers < this
    max_step_kf: int = 15             # --max_step_KF: new KF every N frames
    local_window_kfs: int = 80        # local-map KF cap (Tracking.cc:961)
    init_min_keypoints: int = 100     # MonocularInitialization gate (Tracking.cc:394-412)
    init_min_matches: int = 100       # SearchForInitialization gate (Tracking.cc:425-433)
    init_search_window: float = 100.0  # SearchForInitialization window
    init_ransac_iters: int = 200      # Initializer(sigma=1, 200) (Tracking.cc:406)
    init_sigma: float = 1.0
    init_h_f_ratio: float = 0.40      # RH = SH/(SH+SF) model-selection (Initializer.cc:112-117)
    init_min_triangulated: int = 50   # min triangulated points for accepted init
    init_min_parallax_deg: float = 1.0

    # ------------------------------------------------------------------ #
    # Pose optimization / BA (ref: src/vslam/src/Optimizer.cc)
    # ------------------------------------------------------------------ #
    chi2_mono: float = 5.991          # 2-DoF 95% gate (Optimizer.cc:290 etc.)
    pose_opt_rounds: int = 4          # PoseOptimization: 4 rounds x 10 its (239-413)
    pose_opt_iters: int = 10
    local_ba_iters1: int = 5          # LocalBundleAdjustment first stage
    local_ba_iters2: int = 10         # ... second stage after outlier removal
    global_ba_iters: int = 20         # GlobalBundleAdjustemnt(20) at init (Tracking.cc:535)
    loop_gba_iters: int = 10          # RunGlobalBundleAdjustment(10)
    huber_delta: float = 2.447        # sqrt(5.991), Huber kernel in local BA

    # Static capacities for local BA windows (fixed shapes).  The
    # reference optimizes the FULL covisible set with all other observers
    # fixed (Optimizer.cc:415-735, no cap); 32/32 covers the dense-revisit
    # windows of KITTI 00/02/08 where a 16-KF cap cut the window in half —
    # power-of-two bucketing means small windows never pay for the cap.
    local_ba_max_kfs: int = 32        # optimised cameras per local BA
    local_ba_max_fixed: int = 32      # fixed anchor cameras
    local_ba_max_points: int = 8192
    local_ba_max_obs: int = 32768

    # ------------------------------------------------------------------ #
    # Local mapping (ref: src/vslam/src/LocalMapping.cc)
    # ------------------------------------------------------------------ #
    triangulation_neighbors: int = 20  # CreateNewMapPoints: 20 best covisible KFs
    # minimum parallax for NEW map points, as a cosine bound: the reference
    # accepts cosParallax < 0.9998 (~1.15 deg).  Low-parallax midpoint
    # triangulations carry a systematic depth bias that compounds into
    # per-metre scale drift on corridor geometry — tightening this is the
    # scale-drift lever (A/B'd on the corridor drift probe).
    triangulation_min_parallax_cos: float = 0.9998
    min_baseline_depth_ratio: float = 0.01  # baseline/medianDepth gate (LocalMapping.cc:~360)
    mp_cull_min_found_ratio: float = 0.25   # MapPointCulling found/visible
    mp_cull_min_obs: int = 2
    kf_cull_redundancy: float = 0.9   # KeyFrameCulling >=90% redundant MPs (LocalMapping.cc:739+)
    covis_weight_graph: int = 15      # covisibility edge threshold (KeyFrame.cc:584)
    covis_weight_posegraph: int = 30  # saved pose-graph edges (System.cc:407)
    covis_weight_essential: int = 100  # essential-graph minFeat (Optimizer.cc:762)

    # ------------------------------------------------------------------ #
    # Relocalization (ref: Tracking.cc:1095-1266, PnPsolver params 1141)
    # ------------------------------------------------------------------ #
    reloc_ransac_prob: float = 0.99
    reloc_ransac_min_inliers: int = 10
    reloc_ransac_iters: int = 300
    reloc_ransac_th2: float = 5.991
    reloc_min_inliers: int = 50       # acceptance (Tracking.cc:1239)

    # ------------------------------------------------------------------ #
    # Loop closing (ref: LoopClosing.cc, KeyFrameDatabase.cc)
    # ------------------------------------------------------------------ #
    loop_min_kfs_between: int = 10    # skip if <10 KFs since last loop (LoopClosing.cc:144)
    loop_exclude_recent_kfs: int = 15  # candidates must be >= this many KFs old
    # (not in the reference, which relies on covisibility exclusion alone; a
    # temporal guard is needed when descriptors are weak/untrained)
    loop_consistency_th: int = 3      # mnCovisibilityConsistencyTh (LoopClosing.cc:43)
    loop_bow_common_words: float = 0.6  # minCommonWords factor (KeyFrameDatabase.cc:129)
    loop_bow_group_retain: float = 0.55  # accScore retain factor (KeyFrameDatabase.cc:184)
    reloc_bow_common_words: float = 0.8  # reloc variant (KeyFrameDatabase.cc:248)
    reloc_bow_group_retain: float = 0.75  # (KeyFrameDatabase.cc:303)
    sim3_ransac_prob: float = 0.99    # Sim3Solver params (LoopClosing.cc:313)
    sim3_ransac_min_inliers: int = 20
    sim3_ransac_iters: int = 300
    sim3_min_inliers: int = 20        # OptimizeSim3 acceptance (LoopClosing.cc)
    loop_min_total_matches: int = 40  # guided-reprojection gate (ComputeSim3)
    fuse_radius: float = 4.0          # SearchAndFuse radius (LoopClosing.cc:603-631)

    # ------------------------------------------------------------------ #
    # Vocabulary / BoW (ref: src/dbow2 TemplatedVocabulary, FSift)
    # ------------------------------------------------------------------ #
    vocab_branching: int = 10
    vocab_depth: int = 4              # levels; direct index at level 4 (Frame.cc:294)
    vocab_direct_index_level: int = 4

    # ------------------------------------------------------------------ #
    # Multi-device (SURVEY.md §2.4 distributed-BA row).
    # n_devices > 1 routes the loop-closure global BA through the
    # point-major distributed solver (parallel/dist.py) on a device mesh:
    # points block-sharded, observations grouped with their points, the
    # only collectives the O(C^2) psums of the reduced camera system.
    # ------------------------------------------------------------------ #
    n_devices: int = 1

    # Localization mode: extend the prior map while localized against it
    # (the reference's Loc mode keeps tracking against a loaded map and can
    # insert new keyframes; prior-map entities carry GlobalMapFlag,
    # KeyFrame.h:142-143, and candidate searches filter on it).  False =
    # pure localization (no map mutation).
    loc_extend_map: bool = False

    # ------------------------------------------------------------------ #
    # Map store static capacities
    # ------------------------------------------------------------------ #
    max_keyframes: int = 2048
    max_map_points: int = 262144
    max_obs_per_point: int = 32

    # ------------------------------------------------------------------ #
    # Camera (filled from camera-config file; KITTI 04-12 defaults here)
    # ref: cameraconfig/KITTI/kitti04-12.txt, read_write.cpp:27-60
    # ------------------------------------------------------------------ #
    image_width: int = 1241
    image_height: int = 376
    fx: float = 707.0912
    fy: float = 707.0912
    cx: float = 601.8873
    cy: float = 183.1104
    dist_coeffs: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)

    # ------------------------------------------------------------------ #
    # Derived helpers
    # ------------------------------------------------------------------ #
    @property
    def scale_factors(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** i for i in range(self.n_levels))

    @property
    def inv_level_sigma2(self) -> Tuple[float, ...]:
        return tuple(1.0 / (s * s) for s in self.scale_factors)

    @property
    def level_sigma2(self) -> Tuple[float, ...]:
        return tuple(s * s for s in self.scale_factors)

    @property
    def has_distortion(self) -> bool:
        return any(abs(c) > 1e-12 for c in self.dist_coeffs)

    @property
    def undistorted_bounds(self) -> Tuple[float, float, float, float]:
        """(x_min, x_max, y_min, y_max) of the undistorted image — the
        reference computes these by undistorting the image corners
        (Frame::ComputeImageBounds, src/vslam/src/Frame.cc:330-358) and uses
        them for the frustum check instead of the raw image rectangle."""
        w, h = float(self.image_width), float(self.image_height)
        if not self.has_distortion:
            return (0.0, w, 0.0, h)
        import numpy as np
        k1, k2, p1, p2 = self.dist_coeffs
        corners = np.array([[0.0, 0.0], [w, 0.0], [0.0, h], [w, h]])
        xd = np.stack([(corners[:, 0] - self.cx) / self.fx,
                       (corners[:, 1] - self.cy) / self.fy], axis=-1)
        xn = xd.copy()
        for _ in range(8):  # fixed-point inversion (camera.undistort_normalized)
            x, y = xn[:, 0], xn[:, 1]
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            xn = np.stack([(xd[:, 0] - dx) / radial,
                           (xd[:, 1] - dy) / radial], axis=-1)
        u = xn[:, 0] * self.fx + self.cx
        v = xn[:, 1] * self.fy + self.cy
        return (float(min(u[0], u[2])), float(max(u[1], u[3])),
                float(min(v[0], v[1])), float(max(v[2], v[3])))

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)
