"""Binary `.map` persistence with byte-level format parity.

Port of ``asdslam_tpu/mapping/persistence.py``: the Python ``struct`` writer
and reader, the native route through ``asdslam_torch/native`` (the default,
as in the reference; ``use_native=False`` is the struct route), and the
store's export/import with the features as torch tensors.  Files come out
byte-identical to the JAX package's from the same store, quirks included:
distortion written as 0, the keypoints written from ``uv_und``, descriptors
128 wide on import.

It implements the exact on-disk layout of the reference's hand-rolled
little-endian serializer (src/visual_map/src/visual_map_seri.cc:56-341 —
save_visual_map/loader_visual_map), which is the checkpoint format of the
whole system (System::saveToVisualMap / LoadORBMap, System.cc:296-439,
38-110):

    header:  gps_anchor (3 x f64), Tbc position (3 x f32), Tbc quat wxyz (4 x f32)
    mappoints: i32 count, then 3 x f32 position each
    frames: i32 count, then per frame:
        file name (i32 len + bytes), f64 timestamp,
        camera CENTRE twc (3 x f32), Rwc quaternion wxyz (4 x f32),
        fx fy cx cy k1 k2 p1 p2 (f32), width height (i32),
        gps position (3 x f32), gps accuracy (f32),
        i32 kp count, per kp: x (f32), y (f32), mappoint index (i32, -1 =
            none), octave (i32),
        desc_width (i32), desc_count (i32), then desc_count x desc_width f32
            (descriptor-major),
        i32 imu count, per entry: acce (3 x f32), gyro (3 x f32), time (f64),
        imu_next_frame id (i32, -1 = none)
    pose-graph edges: i32 count, per edge: rel position (3 x f32),
        rel quaternion wxyz (4 x f32), scale (f32), weight (f32),
        v1 id (i32), v2 id (i32)

Poses are stored RELATIVE to the first keyframe (System.cc:300-310), as
world-from-camera (centre + Rwc quaternion).
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

import torch

from asdslam_torch.frontend.extractor import FrameFeatures
from asdslam_torch.frontend.tracking import _np_mat_to_quat
from asdslam_torch.mapping.map_store import MapStore, _pose_np
from asdslam_torch.native import loader as native


class VisualMapData:
    """Plain in-memory representation of a .map file (vm::VisualMap analog)."""

    def __init__(self):
        self.gps_anchor = np.zeros(3, np.float64)
        self.tbc_posi = np.zeros(3, np.float32)
        self.tbc_quat = np.array([1, 0, 0, 0], np.float32)  # wxyz
        self.mp_positions = np.zeros((0, 3), np.float32)
        self.frames: List[dict] = []
        # pose graph edges
        self.edge_posi = np.zeros((0, 3), np.float32)
        self.edge_quat = np.zeros((0, 4), np.float32)
        self.edge_scale = np.zeros(0, np.float32)
        self.edge_weight = np.zeros(0, np.float32)
        self.edge_v1 = np.zeros(0, np.int32)
        self.edge_v2 = np.zeros(0, np.int32)


def save_visual_map(data: VisualMapData, path: str, use_native: bool = True):
    """Write ``data`` to ``path``: through the native serializer unless
    ``use_native`` is False or the map holds IMU payloads, which only the
    struct writer takes; both write the same bytes."""
    if use_native and native.map_save_native(path, data):
        return
    with open(path, "wb") as f:
        w = f.write
        w(struct.pack("<3d", *data.gps_anchor))
        w(struct.pack("<3f", *data.tbc_posi))
        w(struct.pack("<4f", *data.tbc_quat))

        w(struct.pack("<i", len(data.mp_positions)))
        w(np.ascontiguousarray(data.mp_positions, "<f4").tobytes())

        w(struct.pack("<i", len(data.frames)))
        for fr in data.frames:
            name = fr["file_name"].encode()
            w(struct.pack("<i", len(name)))
            w(name)
            w(struct.pack("<d", fr["time_stamp"]))
            w(struct.pack("<3f", *fr["position"]))
            w(struct.pack("<4f", *fr["direction"]))  # wxyz
            w(struct.pack("<8f", fr["fx"], fr["fy"], fr["cx"], fr["cy"],
                          fr["k1"], fr["k2"], fr["p1"], fr["p2"]))
            w(struct.pack("<2i", fr["width"], fr["height"]))
            w(struct.pack("<3f", *fr["gps_position"]))
            w(struct.pack("<f", fr["gps_accu"]))
            kps = fr["kps"]            # [N, 2] f32
            obs = fr["obs_mp"]         # [N] i32
            octv = fr["octave"]        # [N] i32
            w(struct.pack("<i", len(kps)))
            for j in range(len(kps)):
                w(struct.pack("<2f", kps[j, 0], kps[j, 1]))
                w(struct.pack("<i", int(obs[j])))
                w(struct.pack("<i", int(octv[j])))
            desc = fr["descriptors"]   # [N, D] f32 (rows = keypoints)
            desc_width = desc.shape[1] if len(desc) else 0
            w(struct.pack("<2i", desc_width, len(desc)))
            w(np.ascontiguousarray(desc, "<f4").tobytes())
            imu = fr.get("imu", [])
            w(struct.pack("<i", len(imu)))
            for (acce, gyro, ts) in imu:
                w(struct.pack("<3f", *acce))
                w(struct.pack("<3f", *gyro))
                w(struct.pack("<d", ts))
            w(struct.pack("<i", fr.get("imu_next_frame", -1)))

        E = len(data.edge_v1)
        w(struct.pack("<i", E))
        for i in range(E):
            w(struct.pack("<3f", *data.edge_posi[i]))
            w(struct.pack("<4f", *data.edge_quat[i]))
            w(struct.pack("<f", data.edge_scale[i]))
            w(struct.pack("<f", data.edge_weight[i]))
            w(struct.pack("<2i", int(data.edge_v1[i]), int(data.edge_v2[i])))


def load_visual_map(path: str, use_native: bool = True) -> VisualMapData:
    """Read a .map file: through the native deserializer unless
    ``use_native`` is False (the struct reader)."""
    if use_native:
        return native.map_load_native(path)
    data = VisualMapData()
    with open(path, "rb") as f:
        def rd(fmt):
            size = struct.calcsize(fmt)
            return struct.unpack(fmt, f.read(size))

        data.gps_anchor = np.array(rd("<3d"))
        data.tbc_posi = np.array(rd("<3f"), np.float32)
        data.tbc_quat = np.array(rd("<4f"), np.float32)

        n_mp, = rd("<i")
        data.mp_positions = np.frombuffer(f.read(12 * n_mp), "<f4").reshape(n_mp, 3).copy()

        n_frames, = rd("<i")
        for _ in range(n_frames):
            slen, = rd("<i")
            name = f.read(slen).decode()
            ts, = rd("<d")
            position = np.array(rd("<3f"), np.float32)
            direction = np.array(rd("<4f"), np.float32)
            fx, fy, cx, cy, k1, k2, p1, p2 = rd("<8f")
            width, height = rd("<2i")
            gps_position = np.array(rd("<3f"), np.float32)
            gps_accu, = rd("<f")
            n_kp, = rd("<i")
            kps = np.zeros((n_kp, 2), np.float32)
            obs = np.zeros(n_kp, np.int32)
            octv = np.zeros(n_kp, np.int32)
            for j in range(n_kp):
                kps[j] = rd("<2f")
                obs[j], = rd("<i")
                octv[j], = rd("<i")
            desc_width, desc_count = rd("<2i")
            desc = np.frombuffer(f.read(4 * desc_width * desc_count), "<f4")
            desc = desc.reshape(desc_count, desc_width).copy() if desc_count else np.zeros((0, desc_width), np.float32)
            n_imu, = rd("<i")
            imu = []
            for _ in range(n_imu):
                acce = rd("<3f")
                gyro = rd("<3f")
                its, = rd("<d")
                imu.append((acce, gyro, its))
            imu_next, = rd("<i")
            data.frames.append(dict(
                file_name=name, time_stamp=ts, position=position,
                direction=direction, fx=fx, fy=fy, cx=cx, cy=cy,
                k1=k1, k2=k2, p1=p1, p2=p2, width=width, height=height,
                gps_position=gps_position, gps_accu=gps_accu,
                kps=kps, obs_mp=obs, octave=octv, descriptors=desc,
                imu=imu, imu_next_frame=imu_next))

        n_e, = rd("<i")
        data.edge_posi = np.zeros((n_e, 3), np.float32)
        data.edge_quat = np.zeros((n_e, 4), np.float32)
        data.edge_scale = np.zeros(n_e, np.float32)
        data.edge_weight = np.zeros(n_e, np.float32)
        data.edge_v1 = np.zeros(n_e, np.int32)
        data.edge_v2 = np.zeros(n_e, np.int32)
        for i in range(n_e):
            data.edge_posi[i] = rd("<3f")
            data.edge_quat[i] = rd("<4f")
            data.edge_scale[i], = rd("<f")
            data.edge_weight[i], = rd("<f")
            data.edge_v1[i], data.edge_v2[i] = rd("<2i")
    return data


# --------------------------------------------------------------------------- #
# MapStore <-> VisualMapData
# --------------------------------------------------------------------------- #
def export_map(store: MapStore, cfg, min_posegraph_weight: int = 30) -> VisualMapData:
    """System::saveToVisualMap semantics: poses relative to the first KF as
    (centre, Rwc); covisibility edges with weight >= 30 as pose-graph edges
    (System.cc:391-434)."""
    data = VisualMapData()
    kfs = [k for k in range(store.n_kf) if store.kf_valid[k]]
    if not kfs:
        return data
    # relative to first KF: T_rel = T_k * T_0^-1
    R0, t0 = _pose_np(store.kf_pose[kfs[0]])
    mp_ids = np.nonzero(store.mp_valid[:store.n_mp])[0]
    mp_index = {int(m): i for i, m in enumerate(mp_ids)}
    # map points also go to the first-KF-relative frame: X' = R0 X + t0
    data.mp_positions = (store.mp_pos[mp_ids] @ R0.T + t0).astype(np.float32)

    for k in kfs:
        Rk, tk = _pose_np(store.kf_pose[k])
        # T_rel = T_k T_0^-1
        Rr = Rk @ R0.T
        tr = tk - Rr @ t0
        Rwc = Rr.T
        twc = -Rwc @ tr
        q = _quat_from_R(Rwc)
        h = store.kf_host[k]
        valid = h.valid
        kps = h.uv_und.astype(np.float32)
        octv = h.level.astype(np.int32)
        desc = h.desc.astype(np.float32)
        obs = np.full(len(kps), -1, np.int32)
        for j in range(len(kps)):
            m = store.kf_mp[k, j]
            if m >= 0 and m in mp_index:
                obs[j] = mp_index[m]
        keep = valid
        data.frames.append(dict(
            file_name=f"{int(store.kf_frame_id[k]):06d}.png",
            time_stamp=float(store.kf_frame_id[k]),
            position=twc.astype(np.float32), direction=q.astype(np.float32),
            fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
            k1=0.0, k2=0.0, p1=0.0, p2=0.0,
            width=cfg.image_width, height=cfg.image_height,
            gps_position=np.zeros(3, np.float32), gps_accu=9999.0,
            kps=kps[keep], obs_mp=obs[keep], octave=octv[keep],
            descriptors=desc[keep], imu=[], imu_next_frame=-1))

    # pose-graph edges from covisibility weight >= threshold
    e_posi, e_quat, e_scale, e_weight, e_v1, e_v2 = [], [], [], [], [], []
    kf_slot = {k: i for i, k in enumerate(kfs)}
    for k in kfs:
        for nb, wgt in store.covisibility_weights(k).items():
            if wgt < min_posegraph_weight or nb <= k or nb not in kf_slot:
                continue
            Ra, ta = _pose_np(store.kf_pose[k])
            Rb, tb = _pose_np(store.kf_pose[nb])
            Rrel = Ra @ Rb.T
            trel = ta - Rrel @ tb
            e_posi.append(trel)
            e_quat.append(_quat_from_R(Rrel))
            e_scale.append(1.0)
            e_weight.append(float(wgt))
            e_v1.append(kf_slot[k])
            e_v2.append(kf_slot[nb])
    if e_v1:
        data.edge_posi = np.stack(e_posi).astype(np.float32)
        data.edge_quat = np.stack(e_quat).astype(np.float32)
        data.edge_scale = np.array(e_scale, np.float32)
        data.edge_weight = np.array(e_weight, np.float32)
        data.edge_v1 = np.array(e_v1, np.int32)
        data.edge_v2 = np.array(e_v2, np.int32)
    return data


def import_map(data: VisualMapData, store: MapStore, scale_factors,
               global_map_flag: bool = True, device="cuda"):
    """System::LoadORBMap semantics: rebuild keyframes + map points +
    observations, recompute distinctive descriptors and normals
    (System.cc:38-110).  Each keyframe's features are uploaded once, to
    ``device``."""
    def dev(a):
        return torch.as_tensor(a).to(device)

    mp_remap = {}
    for i, pos in enumerate(data.mp_positions):
        m = store.add_map_point(pos, np.zeros(128, np.float32), -1)
        store.mp_global[m] = global_map_flag
        mp_remap[i] = m

    for fi, fr in enumerate(data.frames):
        q = fr["direction"]
        Rwc = _R_from_quat(q)
        twc = fr["position"]
        R = Rwc.T
        t = -R @ twc
        pose7 = np.concatenate([_quat_from_R(R), t]).astype(np.float32)
        n = len(fr["kps"])
        cap = store.n_feat
        uv = np.zeros((cap, 2), np.float32)
        lvl = np.zeros(cap, np.int32)
        desc = np.zeros((cap, 128), np.float32)
        valid = np.zeros(cap, bool)
        n_use = min(n, cap)
        uv[:n_use] = fr["kps"][:n_use]
        lvl[:n_use] = fr["octave"][:n_use]
        d = fr["descriptors"]
        if len(d):
            desc[:n_use, :d.shape[1]] = d[:n_use]
        valid[:n_use] = True
        uv_d = dev(uv)
        feats = FrameFeatures(
            uv=uv_d, uv_und=uv_d, level=dev(lvl),
            angle=torch.zeros(cap, device=device), score=torch.zeros(cap, device=device),
            desc=dev(desc), valid=dev(valid))
        k = store.add_keyframe(pose7, fi, feats)
        store.kf_global[k] = global_map_flag
        for j in range(n_use):
            mi = int(fr["obs_mp"][j])
            if mi >= 0 and mi in mp_remap:
                store.add_observation(mp_remap[mi], k, j)

    for m in mp_remap.values():
        if store.mp_n_obs[m] == 0:
            store.erase_map_point(m)
            continue
        store.compute_distinctive_descriptor(m)
        store.update_normal_and_depth(m, scale_factors)
    return mp_remap


def _quat_from_R(R):
    return _np_mat_to_quat(np.asarray(R, np.float64)).astype(np.float32)


def _R_from_quat(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
