"""Demo predictor: two-pass single-image multi-task inference + rendering
(the port's own copy of `uni_encoder_tpu/demo/predictor.py`).

Capability spec: reference demo/defaults.py (DefaultPredictor.__call__,
:68-160) and demo/predictor.py (VisualizationDemo.run_on_image :42-82):
  * pass 1 'sequence' at 192x512 with the previous frame -> disparity
    (magma colormap), motion mask, and ego / independent / total optical
    flow visualizations via backproject-project geometry (vis_motion);
  * pass 2 'segmentation' at the SEG test resolution -> semantic / instance
    / panoptic outputs rendered by the visualizer.

One segmentation forward is shared across all requested visualizations
(the reference re-runs the model per task, demo/predictor.py:59-76). The
192x512 frames are PIL-exact Lanczos resizes (`data/image_io.resize_lanczos`)
and the flow geometry runs on the model's device.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data.image_io import resize_lanczos
from ..data.mappers import intrinsics_from_camera_json, resize_shortest_edge
from ..data.tokenizer import tokenize_task
from ..engine.predictor import Predictor
from ..geometry import backproject_depth, disp_to_depth, project_3d
from . import visualizer as vis

# default cityscapes intrinsics (the reference demo hard-codes a camera json
# path, demo/defaults.py:108; these are the standard cityscapes values)
DEFAULT_CAMERA = {
    "intrinsic": {"fx": 2262.52, "fy": 2265.30, "u0": 1096.98, "v0": 513.137},
    "extrinsic": {"baseline": 0.209313},
}
THING_IDS = range(11, 19)  # Cityscapes' things: person .. bicycle


def _flow_map(depth, K, inv_K, motion=None, cam_T_cam=None, device="cpu") -> np.ndarray:
    """2-D pixel motion (h, w, 2) from depth + optional 3D motion map +
    optional ego transform (reference vis_motion semantics)."""
    h, w = depth.shape
    as_t = lambda x: torch.as_tensor(np.array(x, np.float32), device=device)[None]  # noqa: E731
    depth_t, K_t, inv_K_t = as_t(depth), as_t(K), as_t(inv_K)

    xs = (np.arange(w) / w) * 2 - 1
    ys = (np.arange(h) / h) * 2 - 1
    ind_map = np.stack(np.meshgrid(xs, ys, indexing="xy"), axis=-1)  # (h, w, 2)

    cam = backproject_depth(depth_t, inv_K_t, h, w)
    pix_err, _ = project_3d(cam, K_t, None, h, w)
    err = pix_err[0].cpu().numpy() - ind_map

    if motion is not None:
        cam = torch.cat([cam[:, :3] + as_t(motion.reshape(3, -1)), cam[:, 3:]], dim=1)
    T = as_t(cam_T_cam) if cam_T_cam is not None else None
    pix, _ = project_3d(cam, K_t, T, h, w)
    return pix[0].cpu().numpy() - ind_map - err


class VisualizationDemo:
    """`run_on_image` renders one frame (and its previous frame, if given)
    with the port `model` (a `UniEncoder`) through the port's `Predictor`."""

    def __init__(self, cfg: Config, model, camera: Optional[Dict] = None):
        self.cfg = cfg
        self.predictor = Predictor(cfg, model)
        self.predictor.set_thing_ids(list(THING_IDS))
        self.camera = camera or DEFAULT_CAMERA
        self.seq_hw = (192, 512)

    def run_on_image(self, image: np.ndarray, prev_image: Optional[np.ndarray], task: str,
                     timing: Optional[Dict] = None) -> Dict[str, np.ndarray]:
        """image/prev_image: RGB uint8 HWC full resolution. Returns a dict of
        rendered uint8 images keyed by output name. With `timing`, stores the
        seconds of the model passes (`predict_s`: the forwards and their
        post-processing, results on the host) and of the rest
        (`render_s`: resizes, flow geometry and drawing), and the panoptic
        segments and instances the segmentation pass returned."""
        t_start = time.perf_counter()
        predict_s = 0.0
        outputs: Dict[str, np.ndarray] = {}
        h, w = self.seq_hw
        device = self.predictor.device

        # ---- pass 1: sequence (depth / motion / flow)
        if prev_image is not None:
            img_s = resize_lanczos(image, (h, w))
            prev_s = resize_lanczos(prev_image, (h, w))
            t0 = time.perf_counter()
            seq = self.predictor.infer_sequence({"image": img_s, "prev_image": prev_s})
            predict_s += time.perf_counter() - t0
            scaled_disp, depth = disp_to_depth(seq["disp_results"])
            outputs["depth"] = vis.colorize_disparity(np.asarray(scaled_disp))
            outputs["motion_mask"] = (np.clip(seq["motion_mask"], 0, 1) * 255).astype(np.uint8)

            K, inv_K = intrinsics_from_camera_json(self.camera, (h, w))
            depth = np.asarray(depth)
            residual = seq["complete_flow"].transpose(2, 0, 1)  # (3, h, w): complete flow as independent motion
            ego = _flow_map(depth, K, inv_K, motion=None, cam_T_cam=seq["cam_T_cam"], device=device)
            ind = _flow_map(depth, K, inv_K, motion=residual, cam_T_cam=None, device=device)
            tot = _flow_map(depth, K, inv_K, motion=residual, cam_T_cam=seq["cam_T_cam"], device=device)
            outputs["ego_flow"] = vis.flow_to_rgb(ego)
            outputs["independent_flow"] = vis.flow_to_rgb(ind)
            outputs["total_flow"] = vis.flow_to_rgb(tot)

        # ---- pass 2: segmentation (one forward shared across tasks)
        seg_img, _ = resize_shortest_edge(image, self.cfg.input.seg_min_size_test, self.cfg.input.seg_max_size_test)
        item = {
            "image": seg_img,
            "height": image.shape[0],
            "width": image.shape[1],
            "task_tokens": np.asarray(tokenize_task(f"The task is {task}"), np.int32),
        }
        t0 = time.perf_counter()
        seg = self.predictor.infer_segmentation(item)
        predict_s += time.perf_counter() - t0
        if task in ("semantic", "panoptic") and "sem_seg" in seg:
            outputs["semantic"] = vis.draw_sem_seg(image, seg["sem_seg"])
        if task == "panoptic" and "panoptic_seg" in seg:
            pan, infos = seg["panoptic_seg"]
            outputs["panoptic"] = vis.draw_panoptic(image, pan, infos)
        if task in ("instance", "panoptic") and "instances" in seg:
            inst = seg["instances"]
            outputs["instance"] = vis.draw_instances(
                image, inst["masks"], inst["labels"], inst["scores"], boxes=inst.get("boxes"))
        if timing is not None:
            timing["predict_s"] = predict_s
            timing["render_s"] = time.perf_counter() - t_start - predict_s
            timing["segments"] = len(seg["panoptic_seg"][1]) if "panoptic_seg" in seg else 0
            timing["instances"] = len(seg["instances"]["scores"]) if "instances" in seg else 0
        return outputs
