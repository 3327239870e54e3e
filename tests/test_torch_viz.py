"""The port's visualization sink (asdslam_torch/viz.py) on the CPU: twins of
tests/test_viz.py's four tests, and every file the sink writes byte for
byte equal to the JAX package's writer's for the same inputs (PNG, both PLY
kinds, the pose text, a map snapshot, the top-down raster)."""

import os
from collections import namedtuple

import numpy as np
import pytest
import torch

from asdslam_tpu import viz as jviz
from asdslam_tpu.mapping.map_store import MapStore as JStore
from asdslam_torch import viz
from asdslam_torch.io.datasets import _load_png_gray
from asdslam_torch.mapping.map_store import MapStore


def _tiny_store(store_cls=MapStore, as_tensor=torch.as_tensor):
    F = namedtuple("F", "uv uv_und level angle desc valid")
    s = store_cls(max_kfs=8, max_pts=32, n_feat=4, max_obs=4)
    feat = F(uv=np.zeros((4, 2), np.float32), uv_und=np.zeros((4, 2), np.float32),
             level=np.zeros(4, np.int32), angle=np.zeros(4, np.float32),
             desc=np.zeros((4, 128), np.float32), valid=np.ones(4, bool))
    feat = F(*(as_tensor(x) for x in feat))
    for k in range(3):
        pose = np.array([1, 0, 0, 0, 0, 0, float(k)], np.float32)
        s.add_keyframe(pose, k, feat)
    for m in range(6):
        mp = s.add_map_point(np.array([m * 0.5, 0.0, 5.0]), np.zeros(128), 0)
        for k in range(3):
            s.add_observation(mp, k, m % 4)
    return s


@pytest.fixture(autouse=True)
def fresh_sinks():
    viz.VisualizationSink.reset()
    jviz.VisualizationSink.reset()
    yield
    viz.VisualizationSink.reset()
    jviz.VisualizationSink.reset()


def test_png_roundtrip(tmp_path):
    img = (np.arange(40 * 30, dtype=np.uint8).reshape(30, 40) * 3) % 251
    p = str(tmp_path / "x.png")
    viz.write_png_gray(p, img)
    back = _load_png_gray(p)
    np.testing.assert_allclose(back * 255.0, img, atol=0.51)


def test_ply_writers(tmp_path):
    xyz = np.random.default_rng(0).normal(size=(17, 3)).astype(np.float32)
    p1 = str(tmp_path / "pts.ply")
    viz.write_ply_points(p1, xyz, intensity=np.linspace(0, 1, 17))
    txt = open(p1).read()
    assert "element vertex 17" in txt and txt.count("\n") == 17 + 10
    p2 = str(tmp_path / "lines.ply")
    viz.write_ply_lines(p2, xyz[:5], xyz[5:10])
    txt = open(p2).read()
    assert "element edge 5" in txt


def test_sink_topics_and_sequencing(tmp_path):
    # publishing without init is a silent no-op (no ROS master semantics)
    assert viz.publish_3d_points_as_point_cloud(np.zeros((3, 3)), "t") is None

    viz.VisualizationSink.init(str(tmp_path))
    a = viz.publish_3d_points_as_point_cloud(np.zeros((3, 3)), "map/points")
    b = viz.publish_3d_points_as_point_cloud(np.ones((3, 3)), "map/points")
    assert a.endswith("000000.ply") and b.endswith("000001.ply")
    pose7 = np.array([[1, 0, 0, 0, 0.5, 0, 2.0]], np.float32)
    p = viz.publish_vertices_from_pose_vector(pose7, "traj")
    row = open(p).read().split()
    # identity rotation: centre = -t
    assert abs(float(row[1]) + 0.5) < 1e-5 and abs(float(row[3]) + 2.0) < 1e-5


def test_map_snapshot_and_topdown(tmp_path):
    s = _tiny_store()
    starts, ends = viz.covisibility_segments(s, min_weight=3)
    assert len(starts) == 3  # 3 KF pairs all sharing 6 points
    viz.VisualizationSink.init(str(tmp_path))
    viz.publish_map_snapshot(s, min_covis_weight=3)
    assert os.path.exists(tmp_path / "map" / "trajectory" / "000000.txt")
    assert os.path.exists(tmp_path / "map" / "points" / "000000.ply")
    assert os.path.exists(tmp_path / "map" / "covisibility" / "000000.ply")
    img = viz.render_topdown(s, size=128, trajectory=np.array([[0, 0, 0], [0, 0, 2.0]]))
    assert img.shape == (128, 128) and img.max() == 255


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_files_equal_to_the_reference_writers(tmp_path):
    """Every writer and a whole map snapshot: the same bytes as the JAX
    package's from the same inputs; the top-down raster equal."""
    g = np.random.default_rng(3)
    img = g.integers(0, 256, (37, 53)).astype(np.uint8)
    xyz = g.normal(size=(23, 3)).astype(np.float32)
    q = g.normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pose7 = np.concatenate([q, g.normal(size=(5, 3))], axis=1).astype(np.float32)
    trees = []
    for mod, store in ((viz, _tiny_store()), (jviz, _tiny_store(JStore, np.asarray))):
        root = tmp_path / mod.__name__
        mod.write_png_gray(str(root) + ".png", img)
        mod.write_png_gray(str(root) + "_f.png", img.astype(np.float32) / 255.0)
        mod.VisualizationSink.init(str(root))
        mod.publish_3d_points_as_point_cloud(xyz, "pts", intensity=np.linspace(0, 1, 23))
        mod.publish_3d_points_as_point_cloud(xyz, "pts")
        mod.publish_lines(xyz[:7], xyz[7:14], "lines")
        mod.publish_vertices_from_pose_vector(pose7, "poses", ids=np.arange(5) * 3)
        mod.publish_map_snapshot(store, min_covis_weight=3)
        mod.VisualizationSink.publish_image("top", mod.render_topdown(
            store, size=96, trajectory=xyz[:4], min_covis_weight=3))
        mod.VisualizationSink.publish_json("meta", {"a": 1})
        tree = _tree(root)
        for suffix in (".png", "_f.png"):
            with open(str(root) + suffix, "rb") as fh:
                tree[suffix] = fh.read()
        trees.append(tree)
        mod.VisualizationSink.reset()
    assert len(trees[0]) == 11
    assert trees[0].keys() == trees[1].keys()
    for name in trees[0]:
        assert trees[0][name] == trees[1][name], name
