"""The port's datagen and dump helper against the JAX package, on the CPU.

* ``datagen/shapes.py::_kmeans2_labels`` gives scikit-learn's
  ``KMeans(n_clusters=2, n_init=4)`` labels, and ``solid_mer`` the JAX
  function's MER, under the same ``np.random.seed``, leaving numpy's
  global RandomState alike: on the 72 shapes of three rich procedural
  libraries.
* The synthesis stages, the context vectors and the ScanNet and
  Matterport adapters are copies: on the inputs of the JAX package's own
  tests they give its outputs exactly.
* The datagen CLI of both packages, run under the same seeds, writes
  byte-equal files: ``synthesize --procedural --num_aug 2`` on two scans
  (the second pass's scarce-class augmentation included), the same
  without cv2 (the rotating-calipers branch of ``min_area_rect``, which a
  host without cv2 runs), ``export-real``, ``organize-matterport``,
  ``export-real-matterport`` and ``synthesize-matterport``.
* ``eval.dump_helper.dump_results`` writes byte-equal PLYs.
"""

import json
import sys

import numpy as np
import pytest
from sklearn.cluster import KMeans

from backtoreality_tpu.data import scannet_md40_config as jax_md40
from backtoreality_tpu.datagen import cli as jax_cli
from backtoreality_tpu.datagen import context as jax_context
from backtoreality_tpu.datagen import matterport_adapter as jax_mp
from backtoreality_tpu.datagen import scannet_adapter as jax_scannet
from backtoreality_tpu.datagen import shapes as jax_shapes
from backtoreality_tpu.datagen import synthesis as jax_synthesis
from backtoreality_tpu.datagen.library import \
    procedural_library as jax_procedural_library
from backtoreality_tpu.eval.dump_helper import \
    dump_results as jax_dump_results
from backtoreality_tpu_torch.data import scannet_md40_config
from backtoreality_tpu_torch.datagen import (cli, context,
                                             matterport_adapter, scannet_adapter,
                                             shapes, synthesis)
from backtoreality_tpu_torch.datagen.library import (procedural_library,
                                                     rich_procedural_library)
from backtoreality_tpu_torch.eval.dump_helper import dump_results


def _same_tree(a, b):
    """Every file under `a` has a byte-equal twin under `b`, and no other."""
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    assert files
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def _rich_shapes(seed):
    lib = rich_procedural_library(num_families=8,
                                  rng=np.random.default_rng(seed))
    return [r for recs in lib.shapes.values() for r in recs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solid_mer_is_the_jax_function(seed):
    """C.9: the 24 shapes of one library (`shape6_01` among them), each
    under np.random.seed(k) for k = 0, 1, 2: the port's labels equal
    scikit-learn's, its MER the JAX function's, and the global state after
    the call is the same."""
    recs = _rich_shapes(seed)
    assert len(recs) == 24 and "shape6_01" in {r.name for r in recs}
    for rec in recs:
        xy = rec.points[:, 0:2]
        np.random.seed(seed)
        want = KMeans(n_clusters=2, n_init=4).fit(xy).labels_
        after = np.random.get_state()
        np.random.seed(seed)
        got = shapes._kmeans2_labels(xy)
        np.testing.assert_array_equal(got, want, err_msg=rec.name)
        state = np.random.get_state()
        assert state[2] == after[2]
        np.testing.assert_array_equal(state[1], after[1])
        for k in range(3):
            np.random.seed(k)
            want = jax_shapes.solid_mer(rec.points)
            after = np.random.get_state()
            np.random.seed(k)
            assert shapes.solid_mer(rec.points) == want, (rec.name, k)
            np.testing.assert_array_equal(np.random.get_state()[1],
                                          after[1])


def test_min_area_rect_without_cv2(monkeypatch):
    """The rotating-calipers branch (no cv2) gives the JAX one's rect and,
    under one seed, the JAX MER."""
    recs = _rich_shapes(3)[::4]
    monkeypatch.setitem(sys.modules, "cv2", None)
    for rec in recs:
        xy = rec.points[:, 0:2]
        assert shapes.min_area_rect(xy) == jax_shapes.min_area_rect(xy)
        np.random.seed(0)
        want = jax_shapes.solid_mer(rec.points)
        np.random.seed(0)
        assert shapes.solid_mer(rec.points) == want


CLASSES = ["table", "chair", "lamp", "monitor", "door"]
AVG_DIMS = {
    "table": (1.2, 0.8, 0.7, 0.8, 1.2, 0.7),
    "chair": (0.6, 0.6, 0.9, 0.6, 0.6, 0.9),
    "lamp": (0.3, 0.3, 0.5, 0.3, 0.3, 0.5),
    "monitor": (0.5, 0.2, 0.4, 0.2, 0.5, 0.4),
    "door": (1.0, 0.1, 2.0, 0.1, 1.0, 2.0),
}


def _objects(make, rng, n=6):
    """`tests/test_datagen.py::_objects` with either package's class."""
    return [make(i + 1, CLASSES[i % len(CLASSES)],
                 np.array([rng.random() * 6 - 3, rng.random() * 6 - 3, 0.5]))
            for i in range(n)]


@pytest.mark.parametrize("rotated", [False, True])
def test_synthesize_scene_matches_jax(rotated):
    """The three placement stages and the export (tests/test_datagen.py's
    inputs: its library, floor and objects), both box kinds."""
    floor_rng = np.random.default_rng(1)
    floor = np.zeros((2000, 3))
    floor[:, 0:2] = floor_rng.random((2000, 2)) * 8 - 4
    outs = []
    for lib_fn, make, synth in (
            (jax_procedural_library, jax_synthesis.SceneObject,
             jax_synthesis.synthesize_scene),
            (procedural_library, synthesis.SceneObject,
             synthesis.synthesize_scene)):
        np.random.seed(0)
        library = lib_fn(CLASSES, rng=np.random.default_rng(0))
        rng = np.random.default_rng(7)
        objs = _objects(make, rng, n=3 if rotated else 6)
        outs.append(synth(objs, library, AVG_DIMS, rng, floor_points=floor,
                          rotated_boxes=rotated))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert outs[1][3].shape[1] == (8 if rotated else 7)


def test_hidden_point_removal_matches_jax():
    rng = np.random.default_rng(9)
    v = rng.standard_normal((3000, 3))
    xyz = v / np.linalg.norm(v, axis=1, keepdims=True) * rng.random((3000, 1))
    np.testing.assert_array_equal(
        synthesis.hidden_point_removal(xyz, [0, 0, 10.0]),
        jax_synthesis.hidden_point_removal(xyz, [0, 0, 10.0]))


def test_context_matches_jax():
    """tests/test_context.py's scenes: co-occurrence, context vectors, the
    gate and the scarce-scene selection."""
    scenes = {"s0": {"bathtub", "bottle", "toilet"},
              "s1": {"bench", "cup", "chair"}, "s2": {"bed", "sofa"},
              "s3": {"bottle", "toilet"},
              "s4": {"laptop", "keyboard", "desk"}}
    t2c = scannet_md40_config().type2class
    assert t2c == jax_md40().type2class
    names = sorted(scenes)
    labels = [context.cloud_label(scenes[n], t2c) for n in names]
    for got, want in zip(labels, [jax_context.cloud_label(scenes[n], t2c)
                                  for n in names]):
        np.testing.assert_array_equal(got, want)
    cs = context.cooccurrence_matrix(labels)
    np.testing.assert_array_equal(cs, jax_context.cooccurrence_matrix(labels))
    for cls in ("bottle", "bathtub", "wardrobe"):
        np.testing.assert_array_equal(
            context.context_vector(cs, t2c[cls]),
            jax_context.context_vector(cs, t2c[cls]))
    np.testing.assert_array_equal(context.gated(labels, t2c),
                                  jax_context.gated(labels, t2c))
    for top in (None, {"bathtub": 1}, {"bathtub": 2}):
        kw = {} if top is None else {"top_counts": top}
        assert (context.select_scarce_scenes(names, labels, t2c, **kw)
                == jax_context.select_scarce_scenes(names, labels, t2c, **kw))


def write_binary_ply(path, verts):
    """tests/test_scannet_adapter.py's ScanNet-style binary PLY."""
    n = len(verts)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\n"
              "property uchar blue\nproperty uchar alpha\nend_header\n")
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("r", "u1"), ("g", "u1"), ("b", "u1"),
                             ("a", "u1")])
    rec["x"], rec["y"], rec["z"] = verts[:, 0], verts[:, 1], verts[:, 2]
    rec["r"], rec["g"], rec["b"] = verts[:, 3:6].astype(np.uint8).T
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def write_scan(root, scan, blobs, seed):
    """tests/test_context.py::_write_scan with a fixed seed: a floor plane
    and labelled blobs in ScanNet's files."""
    d = root / scan
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    floor = np.zeros((500, 6))
    floor[:, 0:2] = rng.random((500, 2)) * 4
    parts, seg_indices = [floor], [0] * 500
    groups = [{"objectId": 0, "label": "floor", "segments": [0]}]
    for i, (label, offset) in enumerate(blobs, start=1):
        blob = np.zeros((200, 6))
        blob[:, 0:3] = rng.random((200, 3)) * 0.5 + offset
        blob[:, 3:6] = 40 * i
        parts.append(blob)
        seg_indices += [i] * 200
        groups.append({"objectId": i, "label": label, "segments": [i]})
    write_binary_ply(d / f"{scan}_vh_clean_2.ply", np.concatenate(parts))
    (d / f"{scan}_vh_clean_2.0.010000.segs.json").write_text(
        json.dumps({"segIndices": seg_indices}))
    (d / f"{scan}.aggregation.json").write_text(
        json.dumps({"segGroups": groups}))
    (d / f"{scan}.txt").write_text(
        "axisAlignment = 0 -1 0 1 1 0 0 0.5 0 0 1 0 0 0 0 1\n")


@pytest.fixture(scope="module")
def two_scans(tmp_path_factory):
    """tests/test_context.py::TestSynthesizeAug's scans: scene0000_00 with
    a keyboard (gated) and a chair, scene0001_00 with a chair."""
    root = tmp_path_factory.mktemp("datagen_scans")
    write_scan(root, "scene0000_00", [("keyboard", [1.0, 1.0, 0.0]),
                                      ("chair", [2.5, 2.5, 0.0])], seed=0)
    write_scan(root, "scene0001_00", [("chair", [1.5, 1.5, 0.0])], seed=1)
    return root


def _both(tmp_path, argv):
    """Each package's CLI on `argv` + ``--out``, under np.random.seed(0);
    returns the two output directories."""
    outs = []
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        out = tmp_path / name
        np.random.seed(0)
        main([*map(str, argv), "--out", str(out)])
        outs.append(out)
    return outs


def test_cli_synthesize_num_aug_matches_jax(two_scans, tmp_path):
    """`synthesize --procedural --num_aug 2 --seed 0`: byte-equal npy files,
    the augmented copies of the gated scan among them."""
    jax_out, port_out = _both(tmp_path, [
        "synthesize", "--scans_dir", two_scans, "--procedural", "--num_aug",
        2, "--seed", 0])
    _same_tree(jax_out, port_out)
    assert {p.name for p in port_out.glob("*_aug*_vert.npy")} == {
        "scene_aug0_0000_00_vert.npy", "scene_aug1_0000_00_vert.npy"}


def test_cli_synthesize_without_cv2_matches_jax(two_scans, tmp_path,
                                                monkeypatch):
    """The branch a host without cv2 runs: one scan, no augmentation."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    one = tmp_path / "one"
    one.mkdir()
    (one / "scene0001_00").symlink_to(two_scans / "scene0001_00")
    jax_out, port_out = _both(tmp_path, [
        "synthesize", "--scans_dir", one, "--procedural", "--num_aug", 0,
        "--seed", 0])
    _same_tree(jax_out, port_out)


def test_cli_export_real_matches_jax(two_scans, tmp_path):
    _same_tree(*_both(tmp_path, ["export-real", "--scans_dir", two_scans,
                                 "--max_points", 600, "--seed", 3]))


@pytest.fixture(scope="module")
def houses(tmp_path_factory):
    """tests/test_matterport_adapter.py::mini_house, two regions: a turned
    bed, and a chair and a turned table."""
    root = tmp_path_factory.mktemp("datagen_mp")
    region_dir = root / "house0" / "region_segmentations"
    region_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for r, objects in enumerate(([("bed", (2.0, 1.4, 0.6), 0.6)],
                                 [("chair", (0.5, 0.5, 0.9), 0.0),
                                  ("table", (1.2, 0.8, 0.7), 1.1)])):
        floor = np.zeros((400, 6))
        floor[:, 0:2] = rng.random((400, 2)) * 5
        parts, groups = [floor], [
            {"objectId": 0, "label": "floor", "segments": [0]}]
        for i, (label, dims, turn) in enumerate(objects, start=1):
            obj = np.zeros((400, 6))
            pts = (rng.random((400, 3)) - 0.5) * dims
            c, s = np.cos(turn), np.sin(turn)
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            obj[:, 0:3] = pts @ rot.T + [1.0 + 1.5 * i, 2.0, 0.5]
            parts.append(obj)
            groups.append({"objectId": i, "label": label, "segments": [i]})
        write_binary_ply(region_dir / f"region{r}.ply", np.concatenate(parts))
        (region_dir / f"region{r}.vsegs.json").write_text(json.dumps(
            {"segIndices": sum(([i] * len(p) for i, p in enumerate(parts)),
                               [])}))
        (region_dir / f"region{r}.semseg.json").write_text(json.dumps(
            {"segGroups": groups}))
    return root


def test_cli_matterport_matches_jax(houses, tmp_path):
    """organize-matterport, export-real-matterport and
    synthesize-matterport: byte-equal files at every stage."""
    organized = _both(tmp_path / "organized", [
        "organize-matterport", "--houses_dir", houses])
    _same_tree(*organized)
    _same_tree(*_both(tmp_path / "real", [
        "export-real-matterport", "--scans_dir", organized[1],
        "--max_points", 700]))
    virtual = _both(tmp_path / "virtual", [
        "synthesize-matterport", "--scans_dir", organized[1], "--procedural",
        "--seed", 0])
    _same_tree(*virtual)
    assert np.load(virtual[1] / "scene0000_01_bbox.npy").shape == (2, 8)


def test_adapters_match_jax(two_scans, houses, tmp_path):
    """The readers, exports, weak centres and mean sizes of both
    adapters, called as the JAX package's adapter tests call them."""
    scan = two_scans / "scene0000_00"
    for name in ("read_ply_vertices_rgb",):
        np.testing.assert_array_equal(
            getattr(scannet_adapter, name)(scan / "scene0000_00_vh_clean_2.ply"),
            getattr(jax_scannet, name)(scan / "scene0000_00_vh_clean_2.ply"))
    agg = scan / "scene0000_00.aggregation.json"
    assert scannet_adapter.read_aggregation(agg) == \
        jax_scannet.read_aggregation(agg)
    segs = scan / "scene0000_00_vh_clean_2.0.010000.segs.json"
    assert scannet_adapter.read_segmentation(segs) == \
        jax_scannet.read_segmentation(segs)
    for got, want in zip(scannet_adapter.export_scan(scan, max_points=None),
                         jax_scannet.export_scan(scan, max_points=None)):
        np.testing.assert_array_equal(got, want)
    (objs, floor, wall), (jobjs, jfloor, jwall) = (
        scannet_adapter.export_weak_objects(scan),
        jax_scannet.export_weak_objects(scan))
    assert [(o.oid, o.class_name) for o in objs] == [
        (o.oid, o.class_name) for o in jobjs]
    np.testing.assert_array_equal([o.center for o in objs],
                                  [o.center for o in jobjs])
    np.testing.assert_array_equal(floor, jfloor)
    np.testing.assert_array_equal(wall, jwall)

    assert matterport_adapter.read_category_mapping() == \
        jax_mp.read_category_mapping()
    names = matterport_adapter.organize_regions(houses, tmp_path / "port")
    assert names == jax_mp.organize_regions(houses, tmp_path / "jax")
    region = tmp_path / "port" / names[1]
    exported = matterport_adapter.export_region(region, max_points=None)
    for got, want in zip(exported,
                         jax_mp.export_region(region, max_points=None)):
        np.testing.assert_array_equal(got, want)
    (objs, floor, _), (jobjs, jfloor, _) = (
        matterport_adapter.export_weak_objects(region),
        jax_mp.export_weak_objects(region))
    assert [(o.oid, o.class_name) for o in objs] == [
        (o.oid, o.class_name) for o in jobjs]
    np.testing.assert_array_equal(floor, jfloor)
    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "scene0000_01_bbox.npy", exported[3])
    np.testing.assert_array_equal(
        matterport_adapter.compute_class_mean_sizes(data),
        jax_mp.compute_class_mean_sizes(data))


def test_dump_results_matches_jax(tmp_path):
    """tests/test_extras.py::test_dump_results' end_points: byte-equal
    PLYs, the three it names among them."""
    cfg = scannet_md40_config()
    rng = np.random.default_rng(0)
    b, k, k2, n = 1, 8, 4, 100
    ep = {
        "point_clouds": rng.random((b, n, 3)),
        "seed_xyz": rng.random((b, 16, 3)),
        "vote_xyz": rng.random((b, 16, 3)),
        "aggregated_vote_xyz": rng.random((b, k, 3)),
        "objectness_scores": np.stack(
            [np.full((b, k), -5.0), np.full((b, k), 5.0)], -1),
        "center": rng.random((b, k, 3)),
        "heading_scores": rng.random((b, k, cfg.num_heading_bin)),
        "heading_residuals": rng.random((b, k, cfg.num_heading_bin)),
        "size_scores": rng.random((b, k, cfg.num_size_cluster)),
        "size_residuals": rng.random((b, k, cfg.num_size_cluster, 3)) * 0.1,
        "center_label": rng.random((b, k2, 3)),
        "heading_class_label": np.zeros((b, k2), int),
        "heading_residual_label": np.zeros((b, k2)),
        "size_class_label": np.zeros((b, k2), int),
        "size_residual_label": np.zeros((b, k2, 3)),
        "box_label_mask": np.ones((b, k2)),
    }
    dump_results(ep, tmp_path / "port", cfg)
    jax_dump_results(ep, tmp_path / "jax", jax_md40())
    _same_tree(tmp_path / "jax", tmp_path / "port")
    names = {p.name for p in (tmp_path / "port").iterdir()}
    assert {"000000_pc.ply", "000000_pred_confident_nms_bbox.ply",
            "000000_gt_bbox.ply"} <= names
