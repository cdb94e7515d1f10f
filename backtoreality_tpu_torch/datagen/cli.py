"""Datagen CLI: real-scene export and virtual-scene synthesis.

Mirrors the reference drivers:
* `export-real`  <- `batch_load_scannet_data.py` (scans -> npy quadruple)
* `synthesize`   <- `scannet_scene_synthesis.py` +
                    `batch_load_scannet_data_virtual.py`
                    (scans -> *_obj_aug virtual detection data), with an
                    optional scarce-class augmentation pass
                    (`scannet_scene_synthesis.py:557-638`): scenes
                    containing bottle/cup/keyboard get `--num_aug`
                    augmented copies (reference: 2) that duplicate the
                    small objects with p=0.75 and insert scarce classes
                    chosen by scene-context vectors (datagen/context.py).

Usage:
  python -m backtoreality_tpu_torch.datagen.cli export-real \
      --scans_dir scans --out scannet_train_detection_data_md40
  python -m backtoreality_tpu_torch.datagen.cli synthesize \
      --scans_dir scans --out scannet_train_detection_data_md40_obj_aug \
      [--modelnet_dir modelnet40_normal_resampled | --procedural]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from backtoreality_tpu_torch.data.config import ASSETS
from backtoreality_tpu_torch.datagen.library import (
    MODELNET40_CLASSES,
    load_modelnet40_library,
    load_modelnet40_mesh_library,
    procedural_library,
)
from backtoreality_tpu_torch.datagen.scannet_adapter import (
    export_scan,
    export_weak_objects,
)
from backtoreality_tpu_torch.datagen import context
from backtoreality_tpu_torch.datagen.synthesis import (
    SceneObject,
    synthesize_scene,
    write_scene,
)


def load_avg_dims():
    """{class_name: 6-tuple} from the frozen object40_property table."""
    prop = np.load(ASSETS / "datagen_scannet" / "object40_property.npy",
                   allow_pickle=True, encoding="bytes").item()
    out = {}
    for mid, vals in prop.items():
        out[MODELNET40_CLASSES[int(mid) - 1]] = tuple(
            float(v) for v in vals[:6])
    return out


def _iter_scans(scans_dir):
    for d in sorted(pathlib.Path(scans_dir).iterdir()):
        if d.is_dir() and (d / f"{d.name}_vh_clean_2.ply").exists():
            yield d


def cmd_export_real(args):
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    for scan_dir in _iter_scans(args.scans_dir):
        verts, sem, ins, bboxes = export_scan(
            scan_dir, max_points=args.max_points, rng=rng)
        np.save(out / f"{scan_dir.name}_vert.npy",
                verts.astype(np.float32))
        np.save(out / f"{scan_dir.name}_sem_label.npy", sem)
        np.save(out / f"{scan_dir.name}_ins_label.npy", ins)
        np.save(out / f"{scan_dir.name}_bbox.npy", bboxes)
        print(f"{scan_dir.name}: {len(verts)} pts, {len(bboxes)} boxes")


def _build_library(args, classes):
    if getattr(args, "modelnet_mesh_dir", None):
        # mesh-version data roots (`*_obj_mesh_aug`): area-weighted
        # surface sampling from the original .off meshes
        return load_modelnet40_mesh_library(
            args.modelnet_mesh_dir, classes=classes,
            max_shapes_per_class=args.max_shapes_per_class,
            seed=args.seed)
    if args.modelnet_dir:
        return load_modelnet40_library(
            args.modelnet_dir, classes=classes,
            max_shapes_per_class=args.max_shapes_per_class)
    return procedural_library(classes,
                              rng=np.random.default_rng(args.seed))


def cmd_synthesize(args):
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    avg_dims = load_avg_dims()
    rng = np.random.default_rng(args.seed)

    cfg_type2class = _md40_type2class()

    scene_records = []
    needed_classes = set()
    for scan_dir in _iter_scans(args.scans_dir):
        objects, floor_points, _ = export_weak_objects(scan_dir)
        if not objects:
            continue
        scene_records.append((scan_dir.name, objects, floor_points))
        needed_classes |= {o.class_name for o in objects}
    needed_classes |= set(context.SCARCE_TOP_COUNTS)
    library = _build_library(args, sorted(needed_classes))

    for name, objects, floor_points in scene_records:
        verts, sem, ins, bboxes = synthesize_scene(
            objects, library, avg_dims, rng,
            floor_points=floor_points, hpr=args.hpr)
        write_scene(out, name, verts, sem, ins, bboxes)
        print(f"{name}: {len(verts)} pts, {len(bboxes)} boxes")

    if args.num_aug > 0 and scene_records:
        _synthesize_scarce_aug(args, out, scene_records, library,
                               avg_dims, cfg_type2class, rng)


def _md40_type2class():
    from backtoreality_tpu_torch.data import scannet_md40_config

    return scannet_md40_config().type2class


def _synthesize_scarce_aug(args, out, scene_records, library, avg_dims,
                           type2class, rng):
    """Context-vector scarce-class augmentation
    (`scannet_scene_synthesis.py:557-638`): per gated scene (contains
    bottle/cup/keyboard), emit `num_aug` augmented copies that
    duplicate small objects with p=0.75 at fresh random positions and
    insert the scarce classes whose context-selected top-N scene lists
    contain this scene."""
    names = [name for name, _, _ in scene_records]
    labels = [context.cloud_label({o.class_name for o in objs},
                                  type2class)
              for _, objs, _ in scene_records]
    selected = context.select_scarce_scenes(names, labels, type2class)
    gate = context.gated(labels, type2class)

    for (name, objects, floor_points), is_gated in zip(scene_records,
                                                       gate):
        if not is_gated:
            continue
        for aug_idx in range(args.num_aug):
            extra = list(objects)
            next_oid = max(o.oid for o in objects) + 1
            added = []
            # scene extent for fresh positions (the reference draws
            # uniformly in the bbox of existing object positions,
            # `scannet_scene_synthesis.py:581-583`; gravity/collision
            # stages then settle them)
            xyzs = np.stack([o.center for o in objects])
            lo, hi = xyzs.min(0), xyzs.max(0)

            def rand_pos():
                return lo + rng.random(3) * (hi - lo)

            # duplicate existing small objects with p=0.75 (:589-595)
            for o in objects:
                if o.class_name in context.DUPLICATE_CLASSES \
                        and rng.random() > 0.25:
                    extra.append(SceneObject(
                        oid=next_oid, class_name=o.class_name,
                        center=rand_pos()))
                    next_oid += 1
                    added.append(o.class_name)
            # insert context-selected scarce classes (:596-625)
            for cls in context.SCARCE_TOP_COUNTS:
                if name not in selected.get(cls, ()):
                    continue
                if cls not in library.shapes:
                    continue
                extra.append(SceneObject(
                    oid=next_oid, class_name=cls, center=rand_pos()))
                next_oid += 1
                added.append(cls)
            if not added:
                continue
            verts, sem, ins, bboxes = synthesize_scene(
                extra, library, avg_dims, rng,
                floor_points=floor_points, hpr=args.hpr)
            # `scene0000_00` -> `scene_aug0_0000_00` (:637)
            aug_name = (name[:5] + f"_aug{aug_idx}_" + name[5:]
                        if name.startswith("scene")
                        else f"{name}_aug{aug_idx}")
            write_scene(out, aug_name, verts, sem, ins, bboxes)
            print(f"{aug_name}: +{added}")


def cmd_organize_matterport(args):
    from backtoreality_tpu_torch.datagen import matterport_adapter as mp

    names = mp.organize_regions(args.houses_dir, args.out)
    print(f"organized {len(names)} regions")


def cmd_export_real_matterport(args):
    from backtoreality_tpu_torch.datagen import matterport_adapter as mp

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    for scene_dir in sorted(pathlib.Path(args.scans_dir).iterdir()):
        if not scene_dir.is_dir():
            continue
        verts, sem, ins, bboxes = mp.export_region(
            scene_dir, max_points=args.max_points, rng=rng)
        np.save(out / f"{scene_dir.name}_vert.npy",
                verts.astype(np.float32))
        np.save(out / f"{scene_dir.name}_sem_label.npy", sem)
        np.save(out / f"{scene_dir.name}_ins_label.npy", ins)
        np.save(out / f"{scene_dir.name}_bbox.npy", bboxes)
        print(f"{scene_dir.name}: {len(verts)} pts, {len(bboxes)} boxes")


def cmd_synthesize_matterport(args):
    from backtoreality_tpu_torch.datagen import matterport_adapter as mp

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    avg_dims = load_avg_dims()
    rng = np.random.default_rng(args.seed)
    scene_records = []
    needed = set()
    for scene_dir in sorted(pathlib.Path(args.scans_dir).iterdir()):
        if not scene_dir.is_dir():
            continue
        objects, floor_points, _ = mp.export_weak_objects(scene_dir)
        if not objects:
            continue
        scene_records.append((scene_dir.name, objects, floor_points))
        needed |= {o.class_name for o in objects}
    library = _build_library(args, sorted(needed))
    for name, objects, floor_points in scene_records:
        verts, sem, ins, bboxes = synthesize_scene(
            objects, library, avg_dims, rng,
            floor_points=floor_points, hpr=args.hpr,
            rotated_boxes=True)
        write_scene(out, name, verts, sem, ins, bboxes)
        print(f"{name}: {len(verts)} pts, {len(bboxes)} rotated boxes")


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("organize-matterport")
    p.add_argument("--houses_dir", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_organize_matterport)

    p = sub.add_parser("export-real-matterport")
    p.add_argument("--scans_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--max_points", type=int, default=50000)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_export_real_matterport)

    p = sub.add_parser("synthesize-matterport")
    p.add_argument("--scans_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--modelnet_dir", default=None)
    p.add_argument("--modelnet_mesh_dir", default=None,
                   help="original ModelNet40 .off meshes; enables the"
                        " mesh-version (*_obj_mesh_aug) data roots via"
                        " area-weighted surface sampling")
    p.add_argument("--procedural", action="store_true")
    p.add_argument("--max_shapes_per_class", type=int, default=20)
    p.add_argument("--hpr", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_synthesize_matterport)

    p = sub.add_parser("export-real")
    p.add_argument("--scans_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--max_points", type=int, default=50000)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_export_real)

    p = sub.add_parser("synthesize")
    p.add_argument("--scans_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--modelnet_dir", default=None)
    p.add_argument("--modelnet_mesh_dir", default=None,
                   help="original ModelNet40 .off meshes; enables the"
                        " mesh-version (*_obj_mesh_aug) data roots via"
                        " area-weighted surface sampling")
    p.add_argument("--procedural", action="store_true")
    p.add_argument("--max_shapes_per_class", type=int, default=20)
    p.add_argument("--hpr", action="store_true")
    p.add_argument("--num_aug", type=int, default=0,
                   help="augmented copies per gated scene"
                        " (reference second pass uses 2)")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_synthesize)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
