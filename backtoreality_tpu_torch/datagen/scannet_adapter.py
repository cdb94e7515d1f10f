"""ScanNet raw-data adapter: real-scene export and weak-object
extraction.

Re-design of `detection/Votenet/scannet/load_scannet_data.py` (export /
export_md40), `batch_load_scannet_data*.py`, and
`data_generation/ScanNet/segment_tools.py:79-167` — without open3d or
plyfile: the binary-little-endian ScanNet `_vh_clean_2.ply` is read
with a minimal numpy parser.

All functions operate on the standard ScanNet scan layout:
  {scan}/{scan}_vh_clean_2.ply            mesh (xyz + rgb)
  {scan}/{scan}.aggregation.json          instance -> segments + label
  {scan}/{scan}_vh_clean_2.0.010000.segs.json  vertex -> segment
  {scan}/{scan}.txt                       meta (axisAlignment)
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from backtoreality_tpu_torch.data.config import ASSETS
from backtoreality_tpu_torch.datagen.synthesis import SceneObject
from backtoreality_tpu_torch.datagen.library import MODELNET40_CLASSES

# md40 benchmark classes (`batch_load_scannet_data.py:22`)
MD40_IDS = (2, 3, 4, 5, 6, 9, 11, 12, 13, 14, 15, 19, 20, 21, 23, 24,
            27, 31, 33, 34, 36, 39)


def read_ply_vertices_rgb(path) -> np.ndarray:
    """(N, 6) xyzrgb from a binary-little-endian PLY (ScanNet flavour)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply", f"not a ply file: {path}"
        fmt = None
        num_verts = 0
        props = []
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1]
            elif line.startswith(b"element vertex"):
                num_verts = int(line.split()[-1])
                in_vertex = True
            elif line.startswith(b"element"):
                in_vertex = False
            elif line.startswith(b"property") and num_verts and \
                    "in_vertex" in dir() and in_vertex:
                parts = line.split()
                props.append((parts[-1].decode(), parts[1].decode()))
            elif line == b"end_header":
                break
        type_map = {"float": "f4", "double": "f8", "uchar": "u1",
                    "uint8": "u1", "int": "i4", "uint": "u4",
                    "ushort": "u2", "short": "i2", "char": "i1"}
        if fmt == b"ascii":
            data = np.loadtxt(f, max_rows=num_verts)
            cols = {name: data[:, i] for i, (name, _) in
                    enumerate(props)}
        else:
            dtype = np.dtype([(name, "<" + type_map[t])
                              for name, t in props])
            raw = f.read(dtype.itemsize * num_verts)
            rec = np.frombuffer(raw, dtype=dtype, count=num_verts)
            cols = {name: rec[name].astype(np.float64)
                    for name, _ in props}
    out = np.zeros((num_verts, 6))
    out[:, 0] = cols["x"]
    out[:, 1] = cols["y"]
    out[:, 2] = cols["z"]
    for i, c in enumerate(("red", "green", "blue")):
        if c in cols:
            out[:, 3 + i] = cols[c]
    return out


def read_aggregation(path):
    """{object_id: [segs]}, {label: [segs]} (`ins_ply.py:10-32`)."""
    object_id_to_segs = {}
    label_to_segs = {}
    with open(path) as f:
        data = json.load(f)
    for group in data["segGroups"]:
        object_id = group["objectId"] + 1  # 1-indexed instance ids
        label = group["label"]
        segs = group["segments"]
        object_id_to_segs[object_id] = segs
        label_to_segs.setdefault(label, []).extend(segs)
    return object_id_to_segs, label_to_segs


def read_segmentation(path):
    """{seg: [vertex indices]}, num_verts (`ins_ply.py:35-47`)."""
    seg_to_verts = {}
    with open(path) as f:
        data = json.load(f)
    seg_indices = data["segIndices"]
    for i, seg in enumerate(seg_indices):
        seg_to_verts.setdefault(seg, []).append(i)
    return seg_to_verts, len(seg_indices)


def get_id_to_label(path):
    with open(path) as f:
        data = json.load(f)
    return {g["objectId"] + 1: g["label"] for g in data["segGroups"]}


def read_axis_align_matrix(meta_file) -> np.ndarray:
    for line in open(meta_file):
        if "axisAlignment" in line:
            vals = [float(x) for x in
                    line.rstrip().strip("axisAlignment = ").split(" ")]
            return np.array(vals).reshape(4, 4)
    return np.eye(4)


def load_label_map(kind: str = "modelnet") -> dict[str, int]:
    name = {"modelnet": "map2modelnet.npy",
            "nyu40": "map2nyu40.npy"}[kind]
    return np.load(ASSETS / "datagen_scannet" / name,
                   allow_pickle=True).item()


def corrected_modelnet_label_map() -> dict[str, int]:
    """The synthesis pipeline's label corrections
    (`segment_tools.py:81-87`)."""
    label_map = dict(load_label_map("modelnet"))
    for key in list(label_map):
        if "door" in key and key != "door":
            label_map[key] = 0
    label_map["ottoman"] = 0
    label_map["bathroom vanity"] = 34  # table
    label_map["sink"] = 0
    return label_map


def _scan_files(scan_dir):
    scan_dir = pathlib.Path(scan_dir)
    scan = scan_dir.name
    return (scan_dir / f"{scan}_vh_clean_2.ply",
            scan_dir / f"{scan}.aggregation.json",
            scan_dir / f"{scan}_vh_clean_2.0.010000.segs.json",
            scan_dir / f"{scan}.txt")


def export_scan(scan_dir, label_map=None, max_points: int | None = 50000,
                keep_ids=MD40_IDS, rng=None):
    """Real-scene export (`load_scannet_data.py export_md40` +
    `batch_load_scannet_data.py:22-76`): axis-aligned verts(+rgb),
    per-vertex semantic/instance labels, per-instance AABBs for the
    benchmark classes, optionally subsampled to max_points.

    Returns (verts (N,6), sem_label, ins_label, bboxes (K,7))."""
    mesh_file, agg_file, seg_file, meta_file = _scan_files(scan_dir)
    if label_map is None:
        label_map = load_label_map("modelnet")
    verts = read_ply_vertices_rgb(mesh_file)
    mat = read_axis_align_matrix(meta_file)
    pts = np.ones((len(verts), 4))
    pts[:, 0:3] = verts[:, 0:3]
    verts[:, 0:3] = (pts @ mat.T)[:, 0:3]

    object_id_to_segs, label_to_segs = read_aggregation(agg_file)
    seg_to_verts, num_verts = read_segmentation(seg_file)
    label_ids = np.zeros(num_verts, dtype=np.uint32)
    for label, segs in label_to_segs.items():
        lid = label_map.get(label, 0)
        for seg in segs:
            label_ids[seg_to_verts[seg]] = lid
    instance_ids = np.zeros(num_verts, dtype=np.uint32)
    object_id_to_label_id = {}
    for object_id, segs in object_id_to_segs.items():
        for seg in segs:
            vs = seg_to_verts[seg]
            instance_ids[vs] = object_id
            if object_id not in object_id_to_label_id:
                object_id_to_label_id[object_id] = int(label_ids[vs[0]])

    bboxes = []
    for obj_id, lid in object_id_to_label_id.items():
        if keep_ids is not None and lid not in keep_ids:
            continue
        obj_pc = verts[instance_ids == obj_id, 0:3]
        if len(obj_pc) == 0:
            continue
        mins, maxs = obj_pc.min(0), obj_pc.max(0)
        bboxes.append([*((mins + maxs) / 2), *(maxs - mins), lid])
    bboxes = np.asarray(bboxes, dtype=np.float64).reshape(-1, 7)

    if max_points is not None and len(verts) > max_points:
        rng = rng or np.random.default_rng(0)
        choice = rng.choice(len(verts), max_points, replace=False)
        verts = verts[choice]
        label_ids = label_ids[choice]
        instance_ids = instance_ids[choice]
    return verts, label_ids, instance_ids, bboxes


def export_weak_objects(scan_dir, scan_name=None, jitter_table=None,
                        scan_name_to_idx=None):
    """The simulated human center-clicks for synthesis
    (`segment_tools.py export_random`): per benchmark-class instance,
    the (frozen-jitter-perturbed) AABB center + class.

    Returns (objects: list[SceneObject], floor_points, wall_points)."""
    mesh_file, agg_file, seg_file, meta_file = _scan_files(scan_dir)
    scan_name = scan_name or pathlib.Path(scan_dir).name
    label_map = corrected_modelnet_label_map()
    verts = read_ply_vertices_rgb(mesh_file)
    mat = read_axis_align_matrix(meta_file)
    pts = np.ones((len(verts), 4))
    pts[:, 0:3] = verts[:, 0:3]
    xyz = (pts @ mat.T)[:, 0:3]

    object_id_to_segs, label_to_segs = read_aggregation(agg_file)
    seg_to_verts, num_verts = read_segmentation(seg_file)
    label_ids = np.zeros(num_verts, dtype=np.uint32)
    for label, segs in label_to_segs.items():
        lid = label_map.get(label, 0)
        for seg in segs:
            label_ids[seg_to_verts[seg]] = lid
    instance_ids = np.zeros(num_verts, dtype=np.uint32)
    for object_id, segs in object_id_to_segs.items():
        for seg in segs:
            vs = seg_to_verts[seg]
            if label_ids[vs[0]] == 0:
                instance_ids[vs] = 0
            else:
                instance_ids[vs] = object_id

    if jitter_table is None:
        jitter_table = np.load(
            ASSETS / "datagen_scannet" / "annotation_error.npy")
    if scan_name_to_idx is None:
        scan_name_to_idx = np.load(
            ASSETS / "datagen_scannet" / "name2idx.npy",
            allow_pickle=True).item()

    id_to_label = get_id_to_label(agg_file)
    objects = []
    obj_idx = -1
    for object_id in object_id_to_segs:
        modelnet_id = label_map.get(id_to_label[object_id], 0)
        obj_pc = xyz[instance_ids == object_id]
        if len(obj_pc) == 0 or modelnet_id not in MD40_IDS:
            continue
        obj_idx += 1
        mins, maxs = obj_pc.min(0), obj_pc.max(0)
        center = (mins + maxs) / 2
        dims = maxs - mins
        if scan_name in scan_name_to_idx:
            center = center + dims * jitter_table[
                scan_name_to_idx[scan_name], obj_idx]
        objects.append(SceneObject(
            oid=int(object_id),
            class_name=MODELNET40_CLASSES[modelnet_id - 1],
            center=center))

    # floor near z=0 after alignment; walls from the nyu40 map
    nyu_map = load_label_map("nyu40")
    nyu_ids = np.zeros(num_verts, dtype=np.uint32)
    for label, segs in label_to_segs.items():
        lid = nyu_map.get(label, 0)
        for seg in segs:
            nyu_ids[seg_to_verts[seg]] = lid
    wall_points = xyz[nyu_ids == 1]
    floor_points = xyz[np.abs(xyz[:, 2]) < 0.05]
    return objects, floor_points, wall_points
