"""Synthetic Cityscapes and KITTI trees in the datasets' own layouts, made
from a seed, for the tests and the smoke runs of the evaluation and
training entry points (no real dataset is needed; the JAX package's tests
write the same layout, tests/test_eval_pipeline.py:20-73).

- `write_cityscapes_val`: `cityscapes/` val images with the panoptic PNG +
  json, `_labelTrainIds` and 16-bit `_instanceIds` maps: sky, building,
  road and sidewalk, two cars and a person, and a void corner;
- `write_cityscapes_sequence`: `cityscapes_crop/` test frames with their
  t-2 / t+2 neighbours, camera json and `gt_depths/*.npy`;
- `write_cityscapes_train`: the panoptic train split and the
  `cityscapes_full_crop/` sequence train split that `train_torch.py` reads;
- `write_kitti`: an Eigen-split KITTI drive with PNG frames, the two
  calibration files and velodyne scans (`register_kitti` registers it);
- `gt_as_prediction`: a segmentation item's GT files as the Predictor's
  outputs, which the evaluators must score as perfect.

Every PNG is written by `image_io.write_png`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

from ..native import decode_panoptic_ids
from .catalog import DatasetCatalog, MetadataCatalog
from .cityscapes_labels import ID_TO_TRAINID, PALETTE, THING_TRAIN_IDS
from .datasets import kitti
from .image_io import read_png, write_png

CITY = "fakecity"
KITTI_HW = (375, 1242)
KITTI_DRIVE = "2011_09_26/2011_09_26_drive_0002_sync"
NUM_CLASSES = 19


def _png(path: str, arr: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, arr)


def _photo(rng: np.random.RandomState, label_rgb: np.ndarray) -> np.ndarray:
    """An RGB frame: the class colours under a brightness ramp and noise."""
    h, w = label_rgb.shape[:2]
    ramp = np.linspace(0.7, 1.1, w, dtype=np.float32)[None, :, None]
    noise = rng.randint(-20, 21, (h, w, 3)).astype(np.float32)
    return np.clip(label_rgb * ramp + noise, 0, 255).astype(np.uint8)


def _layout(rng: np.random.RandomState, h: int, w: int):
    """(panoptic ids, segments): sky, building, road, sidewalk (stuff, id =
    dataset id), two cars and a person (things, id = dataset id * 1000 +
    k), void (id 0) in the bottom-right corner; edges jittered by the rng."""
    j = lambda f, s: int(round((f + rng.uniform(-0.02, 0.02)) * s))  # noqa: E731
    ids = np.zeros((h, w), np.int64)
    ids[: j(0.2, h)] = 23  # sky
    ids[j(0.2, h): j(0.5, h)] = 11  # building
    ids[j(0.5, h):] = 7  # road
    ids[j(0.8, h):, : j(0.3, w)] = 8  # sidewalk
    ids[j(0.55, h): j(0.75, h), j(0.1, w): j(0.3, w)] = 26001  # car
    ids[j(0.55, h): j(0.7, h), j(0.6, w): j(0.85, w)] = 26002  # car
    ids[j(0.4, h): j(0.7, h), j(0.45, w): j(0.5, w)] = 24001  # person
    ids[j(0.95, h):, j(0.9, w):] = 0  # void
    segments = [{"id": int(v), "category_id": int(v) if v < 1000 else int(v) // 1000, "iscrowd": 0}
                for v in np.unique(ids) if v]
    return ids, segments


def _write_panoptic_split(root: str, split: str, n: int, hw: Tuple[int, int], seed: int,
                          instance_ids: bool) -> None:
    h, w = hw
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "cityscapes")
    palette = np.zeros((256, 3), np.float32)  # void (255) is black
    palette[:NUM_CLASSES] = PALETTE
    anns = []
    for i in range(n):
        stem = f"{CITY}_{i:06d}_000019"
        ids, segments = _layout(rng, h, w)
        dataset_id = np.where(ids >= 1000, ids // 1000, ids)
        train = np.full((h, w), 255, np.uint8)
        for did, tid in ID_TO_TRAINID.items():
            train[dataset_id == did] = tid
        _png(os.path.join(base, f"leftImg8bit/{split}", CITY, stem + "_leftImg8bit.png"),
             _photo(rng, palette[train]))
        pan = np.stack([ids % 256, (ids // 256) % 256, ids // 65536], axis=-1).astype(np.uint8)
        _png(os.path.join(base, f"gtFine/cityscapes_panoptic_{split}", stem + "_gtFine_panoptic.png"), pan)
        _png(os.path.join(base, f"gtFine/{split}", CITY, stem + "_gtFine_labelTrainIds.png"), train)
        if instance_ids:
            _png(os.path.join(base, f"gtFine/{split}", CITY, stem + "_gtFine_instanceIds.png"),
                 ids.astype(np.uint16))
        anns.append({"image_id": stem, "file_name": stem + "_gtFine_panoptic.png", "segments_info": segments})
    with open(os.path.join(base, f"gtFine/cityscapes_panoptic_{split}.json"), "w") as f:
        json.dump({"annotations": anns}, f)


def write_cityscapes_val(root: str, n: int = 2, hw: Tuple[int, int] = (1024, 2048), seed: int = 0) -> None:
    """`n` val images of `hw` under root/cityscapes (the panoptic val split)."""
    _write_panoptic_split(root, "val", n, hw, seed, instance_ids=True)


def _scene(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A float RGB scene of 16-pixel blocks, for frames shifted against it."""
    scene = rng.randint(40, 216, (max(h // 16, 2), max(w // 16, 2), 3)).astype(np.float32)
    scene = np.repeat(np.repeat(scene, 16, 0), 16, 1)[:h, :w]
    return np.pad(scene, ((0, h - scene.shape[0]), (0, w - scene.shape[1]), (0, 0)), mode="edge")


def write_cityscapes_train(root: str, n: int = 2, hw: Tuple[int, int] = (1024, 2048), seed: int = 3) -> None:
    """The two training splits `train_torch.py` reads, `n` items each at
    `hw`: `cityscapes_fine_panoptic_train` (images with the panoptic PNG +
    json and `_labelTrainIds`, the scenes of `write_cityscapes_val`) and
    `cityscapes_sequence_crop_full_sequence_train` under
    root/cityscapes_full_crop (t-2, t and t+2 frames of a shifting scene,
    camera json, `train_files.txt`); tests/test_train_cli.py's layout."""
    _write_panoptic_split(root, "train", n, hw, seed, instance_ids=False)
    h, w = hw
    rng = np.random.RandomState(seed + 1)
    base = os.path.join(root, "cityscapes_full_crop")
    lines = []
    for i in range(n):
        fid = 10 + 4 * i
        file_id = f"{CITY}_{i:06d}_{fid:06d}"
        lines.append(f"{CITY} {file_id}")
        scene = _scene(rng, h, w)
        for off, shift in ((-2, -8), (0, 0), (2, 8)):
            name = f"{CITY}_{i:06d}_{fid + off:06d}_leftImg8bit.png"
            _png(os.path.join(base, "leftImg8bit_sequence/train", CITY, name),
                 _photo(rng, np.roll(scene, shift, axis=1)))
        cam_dir = os.path.join(base, "camera/train", CITY)
        os.makedirs(cam_dir, exist_ok=True)
        with open(os.path.join(cam_dir, file_id + "_camera.json"), "w") as f:
            json.dump({"intrinsic": {"fx": 2262.52, "fy": 2265.30, "u0": 1096.98, "v0": 513.14}}, f)
    with open(os.path.join(base, "train_files.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def write_cityscapes_sequence(root: str, n: int = 2, hw: Tuple[int, int] = (1024, 2048),
                              depth_hw: Tuple[int, int] = (1024, 2048), seed: int = 1) -> None:
    """`n` items of the cityscapes_crop_test split: a frame of `hw` with its
    t-2 and t+2 neighbours, a camera json, and a GT depth map of
    `depth_hw` (metres, 0 where invalid)."""
    h, w = hw
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "cityscapes_crop")
    lines = []
    for i in range(n):
        file_id = f"{CITY}_{i:06d}_000019"
        lines.append(f"{CITY} {file_id}")
        scene = _scene(rng, h, w)
        for frame, shift in ((17, -8), (19, 0), (21, 8)):
            name = f"{CITY}_{i:06d}_{frame:06d}_leftImg8bit.png"
            split_dir = "leftImg8bit/test" if frame == 19 else "leftImg8bit_sequence/test"
            _png(os.path.join(base, split_dir, CITY, name), _photo(rng, np.roll(scene, shift, axis=1)))
        cam_dir = os.path.join(base, "camera/test", CITY)
        os.makedirs(cam_dir, exist_ok=True)
        with open(os.path.join(cam_dir, file_id + "_camera.json"), "w") as f:
            json.dump({"intrinsic": {"fx": 2262.52, "fy": 2265.30, "u0": 1096.98, "v0": 513.14},
                       "extrinsic": {"baseline": 0.209313}}, f)
        rows = np.linspace(5.0, 60.0, depth_hw[0], dtype=np.float32)[:, None]
        depth = (rows * rng.uniform(0.8, 1.2, depth_hw)).astype(np.float32)
        depth[rng.rand(*depth_hw) < 0.3] = 0.0
        depth_dir = os.path.join(base, "gt_depths", CITY)
        os.makedirs(depth_dir, exist_ok=True)
        np.save(os.path.join(depth_dir, file_id + "_leftImg8bit.npy"), depth)
    with open(os.path.join(base, "test_files.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def write_kitti(root: str, n: int = 2, seed: int = 2, points: int = 20000) -> str:
    """`n` frames (each with its neighbours) of one KITTI drive as PNG, the
    drive's calibration and a velodyne scan per frame, under
    root/kitti_data; returns the Eigen-style file list's path."""
    rng = np.random.RandomState(seed)
    data = os.path.join(root, "kitti_data")
    date = KITTI_DRIVE.split("/")[0]
    os.makedirs(os.path.join(data, date), exist_ok=True)
    with open(os.path.join(data, date, "calib_cam_to_cam.txt"), "w") as f:
        f.write(f"S_rect_02: {KITTI_HW[1]:.6e} {KITTI_HW[0]:.6e}\n")
        f.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
        f.write("P_rect_02: 721.5377 0 609.5593 44.85728 0 721.5377 172.854 0.2163791 0 0 1 0.002745884\n")
    with open(os.path.join(data, date, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\nT: 0 -0.08 -0.27\n")
    img_dir = os.path.join(data, KITTI_DRIVE, "image_02/data")
    velo_dir = os.path.join(data, KITTI_DRIVE, "velodyne_points/data")
    os.makedirs(velo_dir, exist_ok=True)
    frames = [10 + 3 * i for i in range(n)]
    palette = rng.randint(30, 226, (8, 3)).astype(np.float32)
    for frame in frames:
        for f in (frame - 1, frame, frame + 1):
            blocks = rng.randint(0, 8, (KITTI_HW[0] // 25 + 1, KITTI_HW[1] // 27 + 1))
            labels = np.repeat(np.repeat(blocks, 25, 0), 27, 1)[: KITTI_HW[0], : KITTI_HW[1]]
            _png(os.path.join(img_dir, f"{f:010d}.png"), _photo(rng, palette[labels]))
        scan = np.stack([rng.uniform(2, 70, points), rng.uniform(-20, 20, points), rng.uniform(-2, 1, points),
                         rng.uniform(0, 1, points)], axis=1).astype(np.float32)
        scan.tofile(os.path.join(velo_dir, f"{frame:010d}.bin"))
    files = os.path.join(data, "synthetic_eigen_test_files.txt")
    with open(files, "w") as f:
        f.write("".join(f"{KITTI_DRIVE} {frame} l\n" for frame in frames))
    return files


def register_kitti(root: str, name: str, files: str) -> None:
    """Register the `write_kitti` drive as dataset `name` (PNG frames; the
    builtin KITTI splits read the release's JPEG frames)."""
    data = os.path.join(root, "kitti_data")
    DatasetCatalog.remove(name)
    DatasetCatalog.register(name, lambda: kitti.load_split(data, files, img_ext=".png"))
    MetadataCatalog.get(name).set(left_image_root=data, evaluator_type="kitti_depth")


def gt_as_prediction(item: Dict) -> Dict:
    """A Cityscapes panoptic-split item's GT as the Predictor's outputs:
    one-hot `sem_seg`, `panoptic_seg` with its segments, and the things as
    `instances` of score 1."""
    gt_ids = decode_panoptic_ids(read_png(item["pan_seg_file_name"]))
    seg = np.zeros(gt_ids.shape, np.int32)
    infos, masks, labels = [], [], []
    for new_id, s in enumerate(item["segments_info"], start=1):
        m = gt_ids == s["id"]
        seg[m] = new_id
        isthing = s["category_id"] in THING_TRAIN_IDS
        infos.append({"id": new_id, "category_id": s["category_id"], "isthing": isthing})
        if isthing:
            masks.append(m)
            labels.append(s["category_id"])
    sem = read_png(item["sem_seg_file_name"])
    return {
        "sem_seg": np.eye(NUM_CLASSES, dtype=np.float32)[np.clip(sem, 0, NUM_CLASSES - 1)].transpose(2, 0, 1),
        "panoptic_seg": (seg, infos),
        "instances": {"masks": np.stack(masks) if masks else np.zeros((0,) + seg.shape, bool),
                      "labels": np.asarray(labels, np.int64), "scores": np.ones(len(labels), np.float32)},
    }
