"""Host-side evaluation: box geometry, NMS, AP (numpy, epoch-boundary)."""

from backtoreality_tpu_torch.eval.box3d import (
    get_3d_box,
    get_3d_box_batch,
    box3d_iou,
    flip_axis_to_camera,
    flip_axis_to_depth,
)
from backtoreality_tpu_torch.eval.nms import (
    nms_2d_faster,
    nms_3d_faster,
    nms_3d_faster_samecls,
)
from backtoreality_tpu_torch.eval.eval_det import eval_det, voc_ap
from backtoreality_tpu_torch.eval.ap_helper import (
    APCalculator,
    parse_predictions,
    parse_groundtruths,
)
