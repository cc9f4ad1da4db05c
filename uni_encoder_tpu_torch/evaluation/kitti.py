"""KITTI Eigen depth evaluator (the port's own copy of
`uni_encoder_tpu/evaluation/kitti.py`; the disparity's cv2.resize is
`cityscapes.resize_disparity`).

Capability spec: reference model/evaluation/kitti_evaluation.py — GT depth
maps by projecting velodyne points through the cam/velo calibration
(generate_depth_map :110-162, closest-depth de-dup incl. the sub2ind quirk),
Eigen crop fractions, median scaling, clamp (1e-3, 80), 7 metrics (:211-279).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List

import numpy as np

from ..geometry import disp_to_depth
from .cityscapes import _depth_errors, resize_disparity
from .evaluator import DatasetEvaluator


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    data = {}
    with open(path) as f:
        for line in f:
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                data[key] = value
    return data


def generate_depth_map(calib_dir: str, velo_filename: str, cam: int = 2, vel_depth: bool = False):
    import os

    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam_raw = read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    velo2cam = np.hstack((velo2cam_raw["R"].reshape(3, 3), velo2cam_raw["T"][..., None]))
    velo2cam = np.vstack((velo2cam, np.array([0, 0, 0, 1.0])))

    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)

    R_cam2rect = np.eye(4)
    R_cam2rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    P_velo2im = P_rect @ R_cam2rect @ velo2cam

    velo = np.fromfile(velo_filename, dtype=np.float32).reshape(-1, 4)
    velo[:, 3] = 1.0
    velo = velo[velo[:, 0] >= 0]

    pts = (P_velo2im @ velo.T).T
    pts[:, :2] = pts[:, :2] / pts[:, 2][..., None]
    if vel_depth:
        pts[:, 2] = velo[:, 0]

    # minus 1 to match the KITTI matlab code
    pts[:, 0] = np.round(pts[:, 0]) - 1
    pts[:, 1] = np.round(pts[:, 1]) - 1
    valid = (pts[:, 0] >= 0) & (pts[:, 1] >= 0) & (pts[:, 0] < im_shape[1]) & (pts[:, 1] < im_shape[0])
    pts = pts[valid]

    depth = np.zeros(tuple(im_shape[:2]))
    depth[pts[:, 1].astype(int), pts[:, 0].astype(int)] = pts[:, 2]

    # duplicates -> closest depth (reference sub2ind formulation kept verbatim
    # for protocol equality)
    m, n = depth.shape
    inds = pts[:, 1] * (n - 1) + pts[:, 0] - 1
    for dd in [item for item, count in Counter(inds).items() if count > 1]:
        idx = np.where(inds == dd)[0]
        x_loc = int(pts[idx[0], 0])
        y_loc = int(pts[idx[0], 1])
        depth[y_loc, x_loc] = pts[idx, 2].min()
    depth[depth < 0] = 0
    return depth


class KITTIDepthEvaluator(DatasetEvaluator):
    MIN_DEPTH = 1e-3
    MAX_DEPTH = 80.0

    def __init__(self, dataset_name: str):
        self.dataset_name = dataset_name

    def reset(self):
        self.metrics: List[np.ndarray] = []

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            depth_gt = generate_depth_map(inp["calib_path"], inp["velo_file"], 2, True)
            disp = np.asarray(out["disp_results"]).squeeze()
            pred_disp, _ = disp_to_depth(disp)
            pred_disp = resize_disparity(np.asarray(pred_disp), depth_gt.shape)
            depth_pred = 1.0 / pred_disp

            gt_h, gt_w = depth_gt.shape[:2]
            mask = (depth_gt > self.MIN_DEPTH) & (depth_gt < self.MAX_DEPTH)
            crop = np.array(
                [0.40810811 * gt_h, 0.99189189 * gt_h, 0.03594771 * gt_w, 0.96405229 * gt_w]
            ).astype(np.int32)
            crop_mask = np.zeros_like(mask)
            crop_mask[crop[0] : crop[1], crop[2] : crop[3]] = True
            mask = mask & crop_mask

            depth_pred, depth_gt = depth_pred[mask], depth_gt[mask]
            ratio = np.median(depth_gt) / np.median(depth_pred)
            depth_pred = np.clip(depth_pred * ratio, self.MIN_DEPTH, self.MAX_DEPTH)
            self.metrics.append(_depth_errors(depth_gt, depth_pred))

    def state(self):
        return self.metrics

    def merge_state(self, states):
        self.metrics = [m for shard in states for m in shard]

    def evaluate(self):
        m = np.mean(np.stack(self.metrics), axis=0)
        keys = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
        return {"depth_error": dict(zip(keys, m.tolist()))}
