"""Virtual-scene synthesis: place ModelNet40-style shapes into room
layouts with gravity- and collision-aware refinement, then export
detection training scans.

Host-side numpy, copied from ``backtoreality_tpu/datagen/`` and changed
only in its imports (`shapes.solid_mer` computes scikit-learn's 2-means in
numpy, so the port needs no scikit-learn; cv2 is optional, as there).
``python -m backtoreality_tpu_torch.datagen.cli`` exports real scans and
synthesizes the virtual source domain of BR (``--source_data_root``);
`library.rich_procedural_library` makes the geometry-differentiated
classes of the port's shapefix fixture (`shapefix.py`).
"""

from backtoreality_tpu_torch.datagen.shapes import (
    analyze_shape,
    min_area_rect,
    ShapeRecord,
)
from backtoreality_tpu_torch.datagen.library import (
    ShapeLibrary,
    procedural_library,
    load_modelnet40_library,
    rich_procedural_library,
)
from backtoreality_tpu_torch.datagen.synthesis import (
    SceneObject,
    generate_initial_positions,
    gravity_aware_positions,
    collision_aware_positions,
    export_scene,
    synthesize_scene,
)
