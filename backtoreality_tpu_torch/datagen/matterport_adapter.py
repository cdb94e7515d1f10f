"""Matterport3D raw-data adapter.

Re-design of `detection/Votenet/matterport/{load_matterport_data.py,
batch_load_matterport_data.py, organize_as_scannet.py,
meta_data/get_train_size.py}` and
`data_generation/Matterport3D/segment_tools.py` — numpy-only.

Matterport ships per-house region segmentations:
  {house}/region_segmentations/region{K}.ply          mesh
  {house}/region_segmentations/region{K}.semseg.json  instances
  {house}/region_segmentations/region{K}.vsegs.json   vertex segs
Regions are renamed `scene{house:04d}_{region:02d}` like the reference
and exported with ROTATED boxes: (cx, cy, cz, dx, dy, dz, angle,
modelnet_id) via the footprint min-area rectangle.
"""

from __future__ import annotations

import csv
import pathlib
import shutil

import numpy as np

from backtoreality_tpu_torch.data.config import ASSETS
from backtoreality_tpu_torch.datagen.library import MODELNET40_CLASSES
from backtoreality_tpu_torch.datagen.scannet_adapter import (
    read_aggregation,
    read_ply_vertices_rgb,
    read_segmentation,
    get_id_to_label,
)
from backtoreality_tpu_torch.datagen.shapes import min_area_rect
from backtoreality_tpu_torch.datagen.synthesis import SceneObject

# md40 benchmark ids for matterport (`segment_tools.py:144`)
MD40_IDS_MP = (2, 3, 4, 9, 12, 13, 14, 15, 24, 31, 33, 34, 36)


def read_category_mapping(path=None, label_to="ModelNet40"):
    """raw_category -> ModelNet40 id from category_mapping.tsv
    (`matterport_utils.read_label_mapping` equivalent). The tsv stores
    class *names* in the ModelNet40 column; they are resolved to the
    1-based ModelNet ids."""
    from backtoreality_tpu_torch.datagen.library import MDN_DICT

    path = path or (ASSETS / "matterport" / "category_mapping.tsv")
    mapping = {}
    with open(path, newline="") as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            val = (row.get(label_to) or "").strip()
            if val in MDN_DICT:
                mapping[row["raw_category"]] = MDN_DICT[val]
            else:
                try:
                    mapping[row["raw_category"]] = int(float(val))
                except ValueError:
                    mapping[row["raw_category"]] = 0
    return mapping


def corrected_matterport_label_map():
    """Synthesis-time corrections (`Matterport3D/segment_tools.py:81-89`)."""
    label_map = dict(read_category_mapping())
    for key in list(label_map):
        if "door" in key and key != "door":
            label_map[key] = 0
        if "cabinet" in key:
            label_map[key] = 5
    label_map["countertop"] = 34
    label_map["shelf"] = 5
    label_map["sink"] = 0
    return label_map


def get_mer(points):
    """Rotated footprint rect as (center, (x_size, y_size), angle_rad)
    (`load_matterport_data.py:29-35`)."""
    (cx, cy), (sx, sy), angle = min_area_rect(points[:, 0:2])
    return (cx, cy), (sx, sy), np.radians(angle)


def organize_regions(houses_dir, out_dir, house_names=None,
                     start_house_id: int = 0):
    """House region files -> scene{house:04d}_{region:02d}/ folders
    (`organize_as_scannet.py`). Returns the scene names."""
    houses_dir = pathlib.Path(houses_dir)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if house_names is None:
        house_names = sorted(d.name for d in houses_dir.iterdir()
                             if d.is_dir())
    names = []
    for hid, house in enumerate(house_names, start=start_house_id):
        region_dir = houses_dir / house / "region_segmentations"
        if not region_dir.exists():
            continue
        region_ids = sorted(
            int(p.stem.replace("region", ""))
            for p in region_dir.glob("region*.ply"))
        for rid in region_ids:
            scene = f"scene{hid:04d}_{rid:02d}"
            dst = out_dir / scene
            dst.mkdir(exist_ok=True)
            for suffix in (".ply", ".semseg.json", ".vsegs.json",
                           ".fsegs.json"):
                src = region_dir / f"region{rid}{suffix}"
                if src.exists():
                    shutil.copy(src, dst / src.name)
            names.append(scene)
    return names


def _region_files(scene_dir):
    scene_dir = pathlib.Path(scene_dir)
    plys = sorted(scene_dir.glob("region*.ply"))
    assert plys, f"no region ply in {scene_dir}"
    stem = plys[0].stem
    return (plys[0], scene_dir / f"{stem}.semseg.json",
            scene_dir / f"{stem}.vsegs.json")


def _load_labels(mesh_file, agg_file, seg_file, label_map):
    verts = read_ply_vertices_rgb(mesh_file)
    object_id_to_segs, label_to_segs = read_aggregation(agg_file)
    seg_to_verts, num_verts = read_segmentation(seg_file)
    label_ids = np.zeros(num_verts, dtype=np.uint32)
    for label, segs in label_to_segs.items():
        lid = label_map.get(label, 0)
        for seg in segs:
            if seg in seg_to_verts:
                label_ids[seg_to_verts[seg]] = lid
    instance_ids = np.zeros(num_verts, dtype=np.uint32)
    object_id_to_label_id = {}
    for object_id, segs in object_id_to_segs.items():
        for seg in segs:
            if seg not in seg_to_verts:
                continue
            vs = seg_to_verts[seg]
            instance_ids[vs] = object_id
            if object_id not in object_id_to_label_id:
                object_id_to_label_id[object_id] = int(label_ids[vs[0]])
    return (verts, label_ids, instance_ids, object_id_to_segs,
            object_id_to_label_id)


def export_region(scene_dir, label_map=None,
                  max_points: int | None = 50000, keep_ids=MD40_IDS_MP,
                  rng=None):
    """Real-scene export with ROTATED boxes
    (`load_matterport_data.py export_md40`). Returns
    (verts (N,6), sem, ins, bboxes (K,8))."""
    mesh_file, agg_file, seg_file = _region_files(scene_dir)
    if label_map is None:
        label_map = read_category_mapping()
    (verts, label_ids, instance_ids, object_id_to_segs,
     object_id_to_label_id) = _load_labels(mesh_file, agg_file,
                                           seg_file, label_map)
    bboxes = []
    for obj_id, lid in object_id_to_label_id.items():
        if keep_ids is not None and lid not in keep_ids:
            continue
        obj_pc = verts[instance_ids == obj_id, 0:3]
        if len(obj_pc) == 0:
            continue
        zmin, zmax = obj_pc[:, 2].min(), obj_pc[:, 2].max()
        (cx, cy), (sx, sy), angle = get_mer(obj_pc)
        bboxes.append([cx, cy, (zmin + zmax) / 2, sx, sy, zmax - zmin,
                       angle, lid])
    bboxes = np.asarray(bboxes, dtype=np.float64).reshape(-1, 8)

    if max_points is not None and len(verts) > max_points:
        rng = rng or np.random.default_rng(0)
        choice = rng.choice(len(verts), max_points, replace=False)
        verts = verts[choice]
        label_ids = label_ids[choice]
        instance_ids = instance_ids[choice]
    return verts, label_ids, instance_ids, bboxes


def export_weak_objects(scene_dir, scan_name=None):
    """Weak center-clicks for synthesis
    (`Matterport3D/segment_tools.py export_random`)."""
    mesh_file, agg_file, seg_file = _region_files(scene_dir)
    scan_name = scan_name or pathlib.Path(scene_dir).name
    label_map = corrected_matterport_label_map()
    (verts, label_ids, instance_ids, object_id_to_segs, _) = \
        _load_labels(mesh_file, agg_file, seg_file, label_map)
    xyz = verts[:, 0:3]
    id_to_label = get_id_to_label(agg_file)

    objects = []
    for object_id in object_id_to_segs:
        modelnet_id = label_map.get(id_to_label[object_id], 0)
        obj_pc = xyz[instance_ids == object_id]
        if len(obj_pc) == 0 or modelnet_id not in MD40_IDS_MP:
            continue
        mins, maxs = obj_pc.min(0), obj_pc.max(0)
        objects.append(SceneObject(
            oid=int(object_id),
            class_name=MODELNET40_CLASSES[modelnet_id - 1],
            center=(mins + maxs) / 2))
    floor_z = np.percentile(xyz[:, 2], 1.0)
    floor_points = xyz[np.abs(xyz[:, 2] - floor_z) < 0.05]
    return objects, floor_points, np.zeros((0, 3))


def compute_class_mean_sizes(data_dir, num_class: int = 13,
                             raw_ids=None):
    """Per-class mean RBB sizes from exported bboxes — regenerates
    `matterport_means_md40.npz` (`meta_data/get_train_size.py`)."""
    raw_ids = list(raw_ids or MD40_IDS_MP)
    sums = np.zeros((num_class, 3))
    counts = np.zeros(num_class)
    for bbox_file in pathlib.Path(data_dir).glob("*_bbox.npy"):
        boxes = np.load(bbox_file)
        for b in boxes:
            lid = int(b[-1])
            if lid in raw_ids:
                cls = raw_ids.index(lid)
                sums[cls] += b[3:6]
                counts[cls] += 1
    return sums / np.maximum(counts[:, None], 1)
