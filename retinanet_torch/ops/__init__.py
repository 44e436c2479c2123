"""Post-processing and the hand-written kernels with their plain versions.

Importing this package registers the custom ops
`torch.ops.retinanet_torch.nms_lanes`,
`torch.ops.retinanet_torch.top_k_rows` and
`torch.ops.retinanet_torch.int8_conv2d`; a serving graph saved by
`torch.export` (`export/serving.py`) calls them, so loading one needs this
import first.
"""

from retinanet_torch.ops import (  # noqa: F401
    int8_conv_kernel, nms_kernel, topk_kernel)
