"""Scene-context scarce-class selection for the augmentation pass.

Faithful re-implementation of the reference's context-vector pipeline
(`data_generation/ScanNet/scannet_detection_dataset.py` __main__ at
:261-315 and `scannet_scene_synthesis.py` __main__ :557-638):

1. Build the 22x22 class co-occurrence matrix over all scenes
   (``count_sum[i][j]`` = #scenes containing both class i and j).
2. For each scarce class c in {bathtub, bench, dresser, laptop,
   wardrobe}: normalize its co-occurrence row by the class's own scene
   count and zero the diagonal -> the "context vector" of c.
3. Score every *gated* scene (contains bottle/cup/keyboard — cloud
   label indices 4/6/11) by ``dot(cloud_label, vector_c) -
   cl_rate * sum(cloud_label)`` and keep the top-N scenes per class
   (reference Ns: 40/70/15/55/50 on the 1201-scan train split).
4. The synthesis second pass then, for each gated scene and
   ``aug_idx in range(2)``: duplicates existing cup/bottle/keyboard
   objects with probability 0.75 at fresh uniform positions inside the
   scene's object extent, and inserts each scarce class whose top-N
   list contains the scene.

The placement of inserted objects (random position + theta, dims drawn
0.8-1.3x the class average with a p=0.5 axis swap, nearest-aspect-ratio
shape choice, isotropic scale) is the same initial-placement rule the
first pass uses, so here we only *select* (scene, class) pairs and new
``SceneObject`` seeds; `synthesize_scene` re-runs the gravity/collision
stages exactly as the reference does for the augmented position dicts.
"""

from __future__ import annotations

import numpy as np

# Reference scarce classes and their top-N scene budgets
# (`scannet_detection_dataset.py:305-309`).
SCARCE_TOP_COUNTS = {
    "bathtub": 40,
    "bench": 70,
    "dresser": 15,
    "laptop": 55,
    "wardrobe": 50,
}

# Scenes are eligible for augmentation iff they contain one of these
# (cloud-label indices 4/6/11 in the 22-class md40 ordering,
# `scannet_scene_synthesis.py:566`).
GATE_CLASSES = ("bottle", "cup", "keyboard")

# Existing objects of these classes get duplicated with p=0.75 in each
# augmented copy (`scannet_scene_synthesis.py:589-595`).
DUPLICATE_CLASSES = ("cup", "bottle", "keyboard")

# Score penalty rate (`scannet_detection_dataset.py:280`).
CL_RATE = 0.3


def cloud_label(class_names, type2class) -> np.ndarray:
    """Scene presence vector over the config's class indices
    (the dataset's 22-dim `cloud_label`,
    `scannet_detection_dataset.py:210-213`)."""
    label = np.zeros(len(type2class), np.float64)
    for name in class_names:
        idx = type2class.get(name)
        if idx is not None:
            label[idx] = 1.0
    return label


def cooccurrence_matrix(labels) -> np.ndarray:
    """``count_sum[i][j]`` = #scenes where classes i and j co-occur
    (`scannet_detection_dataset.py:264-274`)."""
    labels = np.asarray(labels, np.float64)
    return labels.T @ labels


def context_vector(count_sum: np.ndarray, cls_idx: int) -> np.ndarray:
    """Row of the co-occurrence matrix normalized by the class's own
    scene count, diagonal zeroed (`scannet_detection_dataset.py:285-93`).
    A class never seen in the dataset gets an all-zero vector."""
    own = count_sum[cls_idx, cls_idx]
    vec = count_sum[cls_idx] / own if own > 0 else \
        np.zeros_like(count_sum[cls_idx])
    vec = np.array(vec)
    vec[cls_idx] = 0.0
    return vec


def gated(labels, type2class) -> np.ndarray:
    """Boolean mask of scenes containing any GATE class
    (`cl[4]+cl[6]+cl[11] == 0` -> skipped)."""
    idxs = [type2class[c] for c in GATE_CLASSES if c in type2class]
    labels = np.asarray(labels)
    if not idxs:
        return np.zeros(len(labels), bool)
    return labels[:, idxs].sum(1) > 0


def select_scarce_scenes(scan_names, labels, type2class, *,
                         top_counts=None, cl_rate=CL_RATE):
    """{scarce_class: set(scan_names)} — the reference's
    `scans_toadd_scarce.npy` content, computed from this dataset's own
    co-occurrence statistics instead of the frozen 1201-scan table.

    Every gated scene is scored per scarce class by how strongly its
    classes co-occur with the scarce class, minus a crowding penalty
    proportional to the scene's class count; top-N scenes win.
    """
    top_counts = dict(SCARCE_TOP_COUNTS if top_counts is None
                      else top_counts)
    labels = np.asarray(labels, np.float64)
    count_sum = cooccurrence_matrix(labels)
    gate = gated(labels, type2class)
    selected = {}
    for cls, top_n in top_counts.items():
        if cls not in type2class:
            continue
        vec = context_vector(count_sum, type2class[cls])
        scores = labels @ vec - cl_rate * labels.sum(1)
        order = [i for i in np.argsort(-scores, kind="stable")
                 if gate[i]]
        selected[cls] = {scan_names[i] for i in order[:top_n]}
    return selected
