"""Post-processing and the hand-written kernels with their plain versions.

Importing this package registers the custom ops
`torch.ops.retinanet_torch.nms_lanes` and
`torch.ops.retinanet_torch.int8_conv2d`; a serving graph saved by
`torch.export` (`export/serving.py`) calls them, so loading one needs this
import first.
"""

from retinanet_torch.ops import int8_conv_kernel, nms_kernel  # noqa: F401
