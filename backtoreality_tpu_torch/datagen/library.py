"""Shape libraries: per-class collections of analyzed shapes.

Sources:
* :func:`load_modelnet40_library` — the real ModelNet40 10k-point txt
  files (y-up, swapped to z-up like `modelnet40_tools.py:17`);
* :func:`procedural_library` — parametric stand-ins (boxes, tabletops
  on legs, thin panels) so the synthesis pipeline runs and is testable
  without the ModelNet40 download.
"""

from __future__ import annotations

import pathlib

import numpy as np

from backtoreality_tpu_torch.datagen.shapes import ShapeRecord, analyze_shape

# ModelNet40 class name -> 1-based id (`scannet_scene_synthesis.py:445`)
MODELNET40_CLASSES = [
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle",
    "bowl", "car", "chair", "cone", "cup", "curtain", "desk", "door",
    "dresser", "flower_pot", "glass_box", "guitar", "keyboard", "lamp",
    "laptop", "mantel", "monitor", "night_stand", "person", "piano",
    "plant", "radio", "range_hood", "sink", "sofa", "stairs", "stool",
    "table", "tent", "toilet", "tv_stand", "vase", "wardrobe", "xbox",
]
MDN_DICT = {n: i + 1 for i, n in enumerate(MODELNET40_CLASSES)}

SUPPORTER_CLASSES = ("tv_stand", "desk", "bed", "bookshelf", "table",
                     "night_stand")
# classes that may sit on supporters (`scannet_scene_synthesis.py:210`)
SUPPORTED_CLASSES = ("monitor", "plant", "lamp", "sink", "cup",
                     "keyboard", "bottle", "laptop")
# scale rules (`scannet_scene_synthesis.py:112-119`)
HEIGHT_ONLY_CLASSES = ("curtain", "door", "sofa", "desk")
AREA_ONLY_CLASSES = ("keyboard",)


class ShapeLibrary:
    """class name -> list[ShapeRecord]."""

    def __init__(self, shapes: dict[str, list[ShapeRecord]]):
        self.shapes = shapes

    def classes(self):
        return sorted(self.shapes)

    def find_nearest(self, class_name: str, ls_ratio: float,
                     require_support: bool = False) -> ShapeRecord:
        """Shape whose footprint aspect ratio is closest to ls_ratio
        (`find_nearest_object`, `scannet_scene_synthesis.py:54-68`)."""
        best, best_d = None, np.inf
        for rec in self.shapes[class_name]:
            if require_support and not rec.supportable:
                continue
            d = abs(rec.ls_ratio - ls_ratio)
            if d < best_d:
                best, best_d = rec, d
        if best is None and require_support:
            return self.find_nearest(class_name, ls_ratio, False)
        if best is None:
            raise KeyError(f"no shapes for class {class_name!r}")
        return best


def load_modelnet40_library(root, classes=None,
                            max_shapes_per_class: int | None = None
                            ) -> ShapeLibrary:
    """Read ModelNet40 txt clouds (x,y,z,nx,ny,nz per line, y-up)."""
    root = pathlib.Path(root)
    shapes: dict[str, list[ShapeRecord]] = {}
    for cls_dir in sorted(root.iterdir()):
        if not cls_dir.is_dir():
            continue
        name = cls_dir.name
        if classes is not None and name not in classes:
            continue
        recs = []
        txts = sorted(cls_dir.glob("*.txt"))
        if max_shapes_per_class:
            txts = txts[:max_shapes_per_class]
        for txt in txts:
            pts = np.loadtxt(txt, delimiter=",")[:, 0:3]
            pts[:, [1, 2]] = pts[:, [2, 1]]  # y-up -> z-up
            recs.append(analyze_shape(txt.stem, pts))
        if recs:
            shapes[name] = recs
    return ShapeLibrary(shapes)


def read_off(path) -> tuple[np.ndarray, np.ndarray]:
    """Parse an OFF mesh -> (verts (V,3) f64, tri faces (F,3) i64).

    Robust to the well-known ModelNet header corruption where the
    counts share the first line with the magic ("OFF490 518 0").
    Polygons with >3 vertices are fan-triangulated.
    """
    with open(path) as f:
        tokens = f.read().split()
    if not tokens or not tokens[0].upper().startswith("OFF"):
        raise ValueError(f"{path}: not an OFF file")
    first = tokens[0]
    rest = tokens[1:]
    if len(first) > 3:  # "OFF490" corruption
        rest = [first[3:]] + rest
    nv, nf = int(rest[0]), int(rest[1])
    pos = 3  # skip nv nf ne
    verts = np.asarray(rest[pos:pos + 3 * nv],
                       dtype=np.float64).reshape(nv, 3)
    pos += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(rest[pos])
        poly = [int(x) for x in rest[pos + 1: pos + 1 + k]]
        pos += 1 + k
        for i in range(1, k - 1):  # fan triangulation
            faces.append((poly[0], poly[i], poly[i + 1]))
    return verts, np.asarray(faces, dtype=np.int64).reshape(-1, 3)


def sample_mesh_points(verts: np.ndarray, faces: np.ndarray, n: int,
                       rng: np.random.Generator) -> np.ndarray:
    """Area-weighted uniform surface sampling: pick triangles with
    probability proportional to area, then a uniform barycentric point
    per pick (sqrt trick). This is what the reference's mesh-version
    data roots (`*_obj_mesh_aug`, README.md:63-100) imply but its
    generator omits."""
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("mesh has zero surface area")
    idx = rng.choice(len(faces), size=n, p=areas / total)
    r1 = rng.random(n)
    r2 = rng.random(n)
    s = np.sqrt(r1)[:, None]
    t = r2[:, None]
    pts = (1 - s) * v0[idx] + s * (1 - t) * v1[idx] + s * t * v2[idx]
    return pts.astype(np.float64)


def load_modelnet40_mesh_library(root, classes=None,
                                 max_shapes_per_class: int | None = None,
                                 points_per_shape: int = 10000,
                                 seed: int = 0) -> ShapeLibrary:
    """Read original ModelNet40 .off meshes and surface-sample clouds.

    Accepts both layouts: `<root>/<class>/*.off` and
    `<root>/<class>/train/*.off` (the official download). Meshes are
    y-up like the txt clouds; swapped to z-up (`modelnet40_tools.py:17`
    convention).
    """
    root = pathlib.Path(root)
    rng = np.random.default_rng(seed)
    shapes: dict[str, list[ShapeRecord]] = {}
    for cls_dir in sorted(root.iterdir()):
        if not cls_dir.is_dir():
            continue
        name = cls_dir.name
        if classes is not None and name not in classes:
            continue
        offs = sorted(cls_dir.glob("*.off"))
        if (cls_dir / "train").is_dir():
            offs += sorted((cls_dir / "train").glob("*.off"))
        if max_shapes_per_class:
            offs = offs[:max_shapes_per_class]
        recs = []
        for off in offs:
            verts, faces = read_off(off)
            if len(faces) == 0:
                continue
            pts = sample_mesh_points(verts, faces, points_per_shape,
                                     rng)
            pts[:, [1, 2]] = pts[:, [2, 1]]  # y-up -> z-up
            recs.append(analyze_shape(off.stem, pts))
        if recs:
            shapes[name] = recs
    return ShapeLibrary(shapes)


def _box_shape(rng, lx, ly, lz, n=10000):
    """Surface-sampled box centered at origin, resting z in [-lz/2, lz/2]."""
    areas = np.array([lx * ly, lx * ly, lx * lz, lx * lz, ly * lz,
                      ly * lz])
    face = rng.choice(6, size=n, p=areas / areas.sum())
    u, v = rng.random(n) - 0.5, rng.random(n) - 0.5
    pts = np.zeros((n, 3))
    half = np.array([lx, ly, lz]) / 2
    for f in range(6):
        m = face == f
        axis = f // 2
        sign = 1.0 if f % 2 == 0 else -1.0
        other = [a for a in range(3) if a != axis]
        pts[m, axis] = sign * half[axis]
        pts[m, other[0]] = u[m] * [lx, ly, lz][other[0]]
        pts[m, other[1]] = v[m] * [lx, ly, lz][other[1]]
    return pts


def _table_shape(rng, lx, ly, lz, top_frac=0.15, n=10000):
    """Flat top slab on four legs — a supportable shape."""
    n_top = int(n * 0.6)
    top = _box_shape(rng, lx, ly, lz * top_frac, n_top)
    top[:, 2] += lz * (1 - top_frac / 2) - lz / 2
    legs = []
    n_leg = (n - n_top) // 4
    for sx in (-1, 1):
        for sy in (-1, 1):
            leg = _box_shape(rng, lx * 0.08, ly * 0.08,
                             lz * (1 - top_frac), n_leg)
            leg[:, 0] += sx * lx * 0.4
            leg[:, 1] += sy * ly * 0.4
            leg[:, 2] -= lz * top_frac / 2
            legs.append(leg)
    return np.concatenate([top] + legs)


def procedural_library(classes, rng=None, shapes_per_class: int = 3
                       ) -> ShapeLibrary:
    """Parametric stand-in shapes for every requested class."""
    rng = rng or np.random.default_rng(0)
    shapes: dict[str, list[ShapeRecord]] = {}
    for name in classes:
        recs = []
        for i in range(shapes_per_class):
            ar = 1.0 + rng.random() * 1.5  # aspect variety
            if name in SUPPORTER_CLASSES:
                pts = _table_shape(rng, ar, 1.0, 0.8 + rng.random() * 0.4)
            elif name in ("curtain", "door"):
                pts = _box_shape(rng, ar, 0.08, 2.0)
            else:
                pts = _box_shape(rng, ar, 1.0, 0.6 + rng.random())
            recs.append(analyze_shape(f"{name}_{i:04d}", pts))
        shapes[name] = recs
    return ShapeLibrary(shapes)


def _cylinder_shape(rng, r, h, n=10000):
    """Lateral surface + caps of a vertical cylinder."""
    lat = int(n * 0.7)
    theta = rng.random(lat) * 2 * np.pi
    z = (rng.random(lat) - 0.5) * h
    side = np.stack([r * np.cos(theta), r * np.sin(theta), z], 1)
    ncap = (n - lat) // 2
    caps = []
    for sign in (1, -1):
        rr = r * np.sqrt(rng.random(ncap))
        th = rng.random(ncap) * 2 * np.pi
        caps.append(np.stack([rr * np.cos(th), rr * np.sin(th),
                              np.full(ncap, sign * h / 2)], 1))
    return np.concatenate([side] + caps)


def _ellipsoid_shape(rng, a, b, c, n=10000):
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * np.array([a, b, c])


def _cone_shape(rng, r, h, n=10000):
    u = np.sqrt(rng.random(n))  # area-uniform along the slant
    theta = rng.random(n) * 2 * np.pi
    return np.stack([r * u * np.cos(theta), r * u * np.sin(theta),
                     h * (0.5 - u)], 1)


def _lshape(rng, lx, ly, lz, n=10000):
    a = _box_shape(rng, lx, ly * 0.4, lz, n // 2)
    a[:, 1] -= ly * 0.3
    bb = _box_shape(rng, lx * 0.4, ly, lz, n - n // 2)
    bb[:, 0] -= lx * 0.3
    return np.concatenate([a, bb])


def _stairs_shape(rng, lx, ly, lz, steps=4, n=10000):
    per = n // steps
    parts = []
    for i in range(steps):
        p = _box_shape(rng, lx, ly / steps, lz * (i + 1) / steps,
                       per)
        p[:, 1] += (i + 0.5) / steps * ly - ly / 2
        p[:, 2] -= lz * (1 - (i + 1) / steps) / 2
        parts.append(p)
    return np.concatenate(parts)


def rich_procedural_library(num_families: int = 8, rng=None,
                            shapes_per_family: int = 3) -> ShapeLibrary:
    """Geometry-differentiated library: `num_families` classes that
    differ by SHAPE (box, table, panel, cylinder, ellipsoid, cone,
    L-shape, stairs), not just box dims. Class names are `shape{i}`;
    used by fixtures that must give the classifier geometric signal
    (e.g. validating reduced-precision recipes)."""
    rng = rng or np.random.default_rng(0)
    makers = [
        lambda ar: _box_shape(rng, ar, 1.0, 0.8),
        lambda ar: _table_shape(rng, ar, 1.0, 1.0),
        lambda ar: _box_shape(rng, ar, 0.06, 1.8),   # thin panel
        lambda ar: _cylinder_shape(rng, 0.4 * ar, 1.2),
        lambda ar: _ellipsoid_shape(rng, 0.6 * ar, 0.45, 0.35),
        lambda ar: _cone_shape(rng, 0.5 * ar, 1.1),
        lambda ar: _lshape(rng, ar, 1.0, 0.7),
        lambda ar: _stairs_shape(rng, ar, 1.2, 1.0),
    ]
    shapes: dict[str, list[ShapeRecord]] = {}
    for f in range(num_families):
        maker = makers[f % len(makers)]
        recs = []
        for i in range(shapes_per_family):
            ar = 0.9 + rng.random() * 0.4
            pts = maker(ar)
            recs.append(analyze_shape(f"shape{f}_{i:02d}", pts))
        shapes[f"shape{f}"] = recs
    return ShapeLibrary(shapes)


def compute_class_avg_dims(library: ShapeLibrary,
                           target_heights: dict[str, float] | None = None
                           ) -> dict[str, tuple]:
    """Per-class average dims in both xy and yx orientations — the
    `object40_property.npy` regenerator
    (`data_generation/ScanNet/meta_data/object_property.py` analog).
    Shapes are normalized clouds, so dims are scaled to an optional
    per-class target height (default 1.0)."""
    out = {}
    for name, recs in library.shapes.items():
        dims = np.stack([r.extents for r in recs])
        scale = 1.0
        if target_heights and name in target_heights:
            scale = target_heights[name] / max(dims[:, 2].mean(), 1e-9)
        dx, dy, dz = (dims.mean(0) * scale).tolist()
        out[name] = (dx, dy, dz, dy, dx, dz)
    return out
