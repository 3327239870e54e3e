"""Plain-text result dumps + readers — read_write_data_lib parity.

Port of ``asdslam_tpu/io/results.py`` (numpy only): the same text, byte for
byte, from the same store.

Writers mirror System::saveResult (src/vslam/src/System.cc:548-661): a
directory of CSV files describing the final map —

- ``traj.txt``   one keyframe per line: ``filename,id,R00,R01,R02,tx,R10,
  R11,R12,ty,R20,R21,R22,tz`` with pose = T_wc relative to the FIRST
  keyframe (System.cc:557 ``Two``; rows are the 3x4 of Twc).
- ``track.txt``  one retained map point (>= 3 observations) per line:
  comma-separated indices into the descriptor list.
- ``posi.txt``   ``x,y,z,`` world position per retained map point.
- ``kps.txt``    per descriptor-list entry: ``x,y,octave,filename``.
- ``desc.txt``   per descriptor-list entry: comma-separated descriptor
  values (the reference writes uint8 ORB bytes; ASD descriptors here are
  float32).

Readers mirror CHAMO::read_* (src/read_write_data_lib/src/read_write.cpp):
read_traj_file (92-122), read_img_time (376-392), read_imu_data (208-229),
read_gps_orth (394-425), read_mp_posi (231+), read_kp_info, read_track_info,
read_desc.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from asdslam_torch.mapping.map_store import MapStore, _pose_np


# --------------------------------------------------------------------------- #
# Writers (System::saveResult parity)
# --------------------------------------------------------------------------- #
def save_result(store: MapStore, out_dir: str,
                filenames: Optional[Dict[int, str]] = None,
                min_track_len: int = 3):
    """Write traj/track/posi/kps/desc txt files describing the final map."""
    os.makedirs(out_dir, exist_ok=True)
    kfs = [k for k in range(store.n_kf) if store.kf_valid[k]]
    if not kfs:
        for name in ("traj", "track", "posi", "kps", "desc"):
            open(os.path.join(out_dir, name + ".txt"), "w").close()
        return

    def fname(k):
        fid = int(store.kf_frame_id[k])
        if filenames and fid in filenames:
            return os.path.basename(filenames[fid])
        return "%06d.png" % fid

    # poses relative to the first keyframe (Two), written as Twc rows
    R0, t0 = _pose_np(store.kf_pose[kfs[0]])
    with open(os.path.join(out_dir, "traj.txt"), "w") as f:
        for k in kfs:
            Rk, tk = _pose_np(store.kf_pose[k])
            Rr = Rk @ R0.T           # T_k<-0
            tr = tk - Rr @ t0
            Rwc = Rr.T
            twc = -Rwc @ tr
            vals = [Rwc[0, 0], Rwc[0, 1], Rwc[0, 2], twc[0],
                    Rwc[1, 0], Rwc[1, 1], Rwc[1, 2], twc[1],
                    Rwc[2, 0], Rwc[2, 1], Rwc[2, 2], twc[2]]
            f.write("%s,%d," % (fname(k), k)
                    + ",".join("%g" % v for v in vals) + "\n")

    # descriptor list shared by track/kps/desc (System.cc:595-620 dedup)
    desc_index: Dict[Tuple[int, int], int] = {}
    desc_entries: List[Tuple[int, int]] = []
    tracks: List[List[int]] = []
    posis: List[np.ndarray] = []
    for m in range(store.n_mp):
        if not store.mp_valid[m]:
            continue
        n = int(store.mp_n_obs[m])
        track_out = []
        for i in range(n):
            key = (int(store.mp_obs_kf[m, i]), int(store.mp_obs_feat[m, i]))
            if not store.kf_valid[key[0]]:
                continue
            if key not in desc_index:
                desc_index[key] = len(desc_entries)
                desc_entries.append(key)
            track_out.append(desc_index[key])
        if len(track_out) >= min_track_len:
            tracks.append(track_out)
            posis.append(store.mp_pos[m])

    with open(os.path.join(out_dir, "track.txt"), "w") as f:
        for t in tracks:
            f.write("".join("%d," % i for i in t) + "\n")
    with open(os.path.join(out_dir, "posi.txt"), "w") as f:
        for p in posis:
            f.write("%g,%g,%g,\n" % (p[0], p[1], p[2]))
    with open(os.path.join(out_dir, "kps.txt"), "w") as f:
        for (k, feat) in desc_entries:
            h = store.kf_host[k]
            f.write("%g,%g,%d,%s\n" % (h.uv_und[feat, 0], h.uv_und[feat, 1],
                                       int(h.level[feat]), fname(k)))
    with open(os.path.join(out_dir, "desc.txt"), "w") as f:
        for (k, feat) in desc_entries:
            d = store.kf_host[k].desc[feat]
            f.write("".join("%g," % v for v in d) + "\n")


# --------------------------------------------------------------------------- #
# Readers (CHAMO::read_* parity)
# --------------------------------------------------------------------------- #
def _lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield line.rstrip(",").split(",")


def read_traj_file(path: str):
    """-> (poses [N, 4, 4] Twc, frame_names, frame_ids)."""
    poses, names, ids = [], [], []
    for sp in _lines(path):
        names.append(sp[0])
        ids.append(int(sp[1]))
        T = np.eye(4)
        T[:3, :4] = np.array([float(v) for v in sp[2:14]]).reshape(3, 4)
        poses.append(T)
    return np.array(poses), names, ids


def read_img_time(path: str):
    """-> (times [N], names)."""
    times, names = [], []
    for sp in _lines(path):
        names.append(sp[0])
        times.append(float(sp[1]))
    return np.array(times), names


def read_imu_data(path: str) -> np.ndarray:
    """-> [N, 7] rows (timestamp, gyro xyz, accel xyz) as in the reference."""
    return np.array([[float(v) for v in sp[:7]] for sp in _lines(path)],
                    np.float64).reshape(-1, 7)


def read_gps_orth(path: str):
    """-> (positions [N, 3], times [N], covs [N], anchor [3])."""
    posis, times, covs = [], [], []
    anchor = np.zeros(3)
    for sp in _lines(path):
        if len(sp) == 3:
            anchor = np.array([float(v) for v in sp])
            continue
        times.append(float(sp[0]))
        posis.append([float(v) for v in sp[1:4]])
        covs.append(int(float(sp[4])))
    return (np.array(posis).reshape(-1, 3), np.array(times),
            np.array(covs, np.int32), anchor)


def read_mp_posi(path: str) -> np.ndarray:
    return np.array([[float(v) for v in sp[:3]] for sp in _lines(path)],
                    np.float32).reshape(-1, 3)


def read_kp_info(path: str):
    """-> (uv [N, 2], octaves [N], frame_names)."""
    uv, octv, names = [], [], []
    for sp in _lines(path):
        uv.append([float(sp[0]), float(sp[1])])
        octv.append(int(sp[2]))
        names.append(sp[3])
    return np.array(uv, np.float32).reshape(-1, 2), np.array(octv, np.int32), names


def read_track_info(path: str) -> List[List[int]]:
    return [[int(v) for v in sp] for sp in _lines(path)]


def read_desc(path: str) -> np.ndarray:
    rows = [[float(v) for v in sp] for sp in _lines(path)]
    return np.array(rows, np.float32) if rows else np.zeros((0, 0), np.float32)
