"""Shape libraries for the synthetic fixtures.

Copies of ``backtoreality_tpu/datagen/{shapes,library}.py``, changed only
in their imports: `library.rich_procedural_library` makes the
geometry-differentiated classes of the shapefix fixture, which
`data.synthetic.write_synthetic_scans` takes as `shape_library`. The
scene synthesis of the JAX package's ``datagen`` is not copied.
"""

from backtoreality_tpu_torch.datagen.shapes import (
    analyze_shape,
    min_area_rect,
    ShapeRecord,
)
from backtoreality_tpu_torch.datagen.library import (
    ShapeLibrary,
    procedural_library,
    rich_procedural_library,
)
