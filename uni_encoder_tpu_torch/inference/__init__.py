from .postprocess import (
    instance_inference,
    panoptic_inference,
    segments_info_from_arrays,
    semantic_inference,
)
from .fused_postprocess import fused_multitask_inference, fused_multitask_inference_plain
