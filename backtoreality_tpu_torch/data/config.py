"""Typed dataset configuration: class maps and box codecs.

One parameterized config replaces the reference's per-dataset classes
(`scannet/model_util_scannet.py:15-149`,
`matterport/model_util_matterport.py:16-105`). The heading codec is
bin-count-parameterized: ScanNet uses 1 bin (axis-aligned boxes, angle
always 0), Matterport 12 bins with true angle2class/class2angle.

Frozen mean-size tables are vendored under `assets/` (byte-identical to
the reference's `meta_data/*.npz` — they define the benchmark).
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib

import numpy as np

ASSETS = pathlib.Path(__file__).resolve().parents[2] / "assets"


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    name: str
    num_class: int
    num_heading_bin: int
    num_size_cluster: int
    type2class: dict[str, int]
    mean_size_arr: np.ndarray  # (num_size_cluster, 3)
    # label-map ids as stored in the *_sem_label / bbox npy files
    # (nyu40 ids for scannet-18, modelnet ids for the md40 benchmarks)
    raw_ids: np.ndarray
    max_num_obj: int = 64

    def __post_init__(self):
        assert self.mean_size_arr.shape == (self.num_size_cluster, 3)

    @property
    def class2type(self) -> dict[int, str]:
        return {v: k for k, v in self.type2class.items()}

    @property
    def raw_id_to_class(self) -> dict[int, int]:
        return {int(r): i for i, r in enumerate(self.raw_ids)}

    # -- heading codec ----------------------------------------------------

    def angle2class(self, angle: float) -> tuple[int, float]:
        """Continuous angle -> (bin id, residual). With 1 bin this is the
        trivial codec (ScanNet's axis-aligned boxes)."""
        nb = self.num_heading_bin
        angle = angle % (2 * np.pi)
        per = 2 * np.pi / nb
        shifted = (angle + per / 2) % (2 * np.pi)
        cls = int(shifted / per)
        residual = shifted - (cls * per + per / 2)
        return cls, residual

    def class2angle(self, cls, residual, to_label_format: bool = True):
        nb = self.num_heading_bin
        if nb == 1:
            # ScanNet: angles are always 0 (`model_util_scannet.py:45-48`)
            return np.zeros_like(np.asarray(residual, dtype=np.float64))
        per = 2 * np.pi / nb
        angle = np.asarray(cls) * per + residual
        if to_label_format:
            angle = np.where(angle > np.pi, angle - 2 * np.pi, angle)
        return angle

    # -- size codec -------------------------------------------------------

    def size2class(self, size: np.ndarray, type_name: str):
        cls = self.type2class[type_name]
        return cls, size - self.mean_size_arr[cls]

    def class2size(self, cls, residual, ratio: float = 1.0):
        return (self.mean_size_arr[cls] + residual) * ratio

    def param2obb(self, center, heading_class, heading_residual,
                  size_class, size_residual):
        """(center, codecs) -> 7-dof OBB [cx,cy,cz,dx,dy,dz,angle] with the
        reference's angle sign flip (`model_util_scannet.py:63-70`)."""
        heading = self.class2angle(heading_class, heading_residual)
        size = self.class2size(int(size_class), size_residual)
        obb = np.zeros(7)
        obb[0:3] = center
        obb[3:6] = size
        obb[6] = float(heading) * -1
        return obb


@functools.cache
def scannet_md40_config() -> DatasetConfig:
    """ScanNet-md40: 22 ModelNet40 classes, axis-aligned boxes
    (`model_util_scannet.py:71-125`)."""
    return DatasetConfig(
        name="scannet_md40",
        num_class=22,
        num_heading_bin=1,
        num_size_cluster=22,
        type2class={
            "bathtub": 0, "bed": 1, "bench": 2, "bookshelf": 3,
            "bottle": 4, "chair": 5, "cup": 6, "curtain": 7, "desk": 8,
            "door": 9, "dresser": 10, "keyboard": 11, "lamp": 12,
            "laptop": 13, "monitor": 14, "night_stand": 15, "plant": 16,
            "sofa": 17, "stool": 18, "table": 19, "toilet": 20,
            "wardrobe": 21,
        },
        mean_size_arr=np.load(ASSETS / "scannet" /
                              "scannet_means_md40.npz")["arr_0"],
        raw_ids=np.array([2, 3, 4, 5, 6, 9, 11, 12, 13, 14, 15, 19, 20,
                          21, 23, 24, 27, 31, 33, 34, 36, 39]),
        max_num_obj=64,
    )


@functools.cache
def scannet_config() -> DatasetConfig:
    """Original 18-class ScanNet benchmark (`model_util_scannet.py:15-70`)."""
    return DatasetConfig(
        name="scannet",
        num_class=18,
        num_heading_bin=1,
        num_size_cluster=18,
        type2class={
            "cabinet": 0, "bed": 1, "chair": 2, "sofa": 3, "table": 4,
            "door": 5, "window": 6, "bookshelf": 7, "picture": 8,
            "counter": 9, "desk": 10, "curtain": 11, "refrigerator": 12,
            "showercurtrain": 13, "toilet": 14, "sink": 15, "bathtub": 16,
            "garbagebin": 17,
        },
        mean_size_arr=np.load(ASSETS / "scannet" /
                              "scannet_means.npz")["arr_0"],
        raw_ids=np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24,
                          28, 33, 34, 36, 39]),
        max_num_obj=64,
    )


@functools.cache
def matterport_md40_config() -> DatasetConfig:
    """Matterport3d-md40: 13 classes, 12 heading bins — rotated boxes
    (`model_util_matterport.py:16-105`)."""
    return DatasetConfig(
        name="matterport_md40",
        num_class=13,
        num_heading_bin=12,
        num_size_cluster=13,
        type2class={
            "bathtub": 0, "bed": 1, "bench": 2, "chair": 3, "curtain": 4,
            "desk": 5, "door": 6, "dresser": 7, "night_stand": 8,
            "sofa": 9, "stool": 10, "table": 11, "toilet": 12,
        },
        mean_size_arr=np.load(ASSETS / "matterport" /
                              "matterport_means_md40.npz")["arr_0"].astype(
                                  np.float32),
        raw_ids=np.array([2, 3, 4, 9, 12, 13, 14, 15, 24, 31, 33, 34,
                          36]),
        max_num_obj=256,
    )


_CONFIGS = {
    "scannet_md40": scannet_md40_config,
    "scannet": scannet_config,
    "matterport_md40": matterport_md40_config,
}


def get_config(name: str) -> DatasetConfig:
    return _CONFIGS[name]()


def rotate_aligned_boxes(input_boxes: np.ndarray,
                         rot_mat: np.ndarray) -> np.ndarray:
    """Rotate axis-aligned boxes, keeping them axis-aligned by taking the
    rotated corners' extent (`model_util_scannet.py:128-149`)."""
    centers, lengths = input_boxes[:, 0:3], input_boxes[:, 3:6]
    new_centers = centers @ rot_mat.T
    dx, dy = lengths[:, 0] / 2.0, lengths[:, 1] / 2.0
    new_x = np.zeros((dx.shape[0], 4))
    new_y = np.zeros((dx.shape[0], 4))
    for i, (cx, cy) in enumerate([(-1, -1), (1, -1), (1, 1), (-1, 1)]):
        crnrs = np.stack([cx * dx, cy * dy, np.zeros_like(dx)], axis=1)
        crnrs = crnrs @ rot_mat.T
        new_x[:, i] = crnrs[:, 0]
        new_y[:, i] = crnrs[:, 1]
    new_dx = 2.0 * np.max(new_x, 1)
    new_dy = 2.0 * np.max(new_y, 1)
    new_lengths = np.stack((new_dx, new_dy, lengths[:, 2]), axis=1)
    return np.concatenate([new_centers, new_lengths], axis=1)
