"""mx.nd.contrib (counterpart of mxnet_tpu/ndarray/contrib.py): the
control-flow ops foreach / while_loop / cond and the contrib detection
ops the port has."""
from ..ops.control_flow import cond, foreach, while_loop  # noqa: F401
from ..ops.detection import (  # noqa: F401
    box_iou, box_nms, multibox_detection, multibox_prior, multibox_target,
    roi_align)
