"""The port's demo (`uni_encoder_tpu_torch/demo/`, `demo_torch.py`) against
the JAX package's (`uni_encoder_tpu/demo/`, `demo.py`), on the CPU at the
scaled profile with Cityscapes' 19 classes:

- every visualizer function gives the JAX one's bytes on the same inputs
  (the JAX side calls matplotlib, the port reads matplotlib's magma table
  from its asset and computes the HSV conversion itself; text labels are
  PIL's in both, so byte equality holds under one PIL);
- `prev_frame_path` is demo.py's;
- `VisualizationDemo.run_on_image` on one d2 state dict: the same
  renderings; the sequence outputs within SEQ_ATOL; each rendering the
  same bytes when both are fed the JAX predictions; end to end at most
  1e-3 of the pixels of each rendering differ;
- `demo_torch.main --device cpu` writes every rendering's directory, with
  matplotlib unimportable.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_port_common as common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = dict(atol=common.SEQ_ATOL, rtol=1e-4)
HW = (64, 96)  # demo frames: the segmentation pass runs at this size, the sequence pass at 192x512
PIXEL_SHARE = 1e-3  # end to end: share of a rendering's pixels that may differ
SEQUENCE_RENDERINGS = ("depth", "motion_mask", "ego_flow", "independent_flow", "total_flow")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- visualizer
def _vis_inputs(rng):
    h, w = HW
    image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    pan = np.zeros((h, w), np.int32)
    infos = []
    for i, cat in enumerate((0, 2, 10, 11, 13, 13, 18), start=1):
        y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
        pan[y:y + rng.randint(6, h // 2), x:x + rng.randint(6, w // 2)] = i
        infos.append({"id": i, "category_id": cat, "isthing": cat >= 11})
    infos.append({"id": 99, "category_id": 5, "isthing": False})  # a segment with no pixels
    masks = rng.rand(6, h, w) > 0.8
    masks[0] = False
    masks[1, 10:30, 20:60] = True
    boxes = np.stack([rng.randint(0, w // 2, 6), rng.randint(0, h // 2, 6),
                      rng.randint(w // 2, w, 6), rng.randint(h // 2, h, 6)], axis=1).astype(np.float32)
    return {
        "image": image, "pan": pan, "infos": infos, "masks": masks, "boxes": boxes,
        "labels": rng.randint(0, 19, 6), "scores": np.asarray([0.9, 0.3, 0.75, 0.5, 0.99, 0.6], np.float32),
        "probs": rng.rand(19, h, w).astype(np.float32), "labels_map": rng.randint(0, 25, (h, w)),
        "disp": (rng.rand(h, w) * 0.3).astype(np.float32),
        "hsv": np.concatenate([rng.rand(h, w, 3)[..., :1], (rng.rand(h, w, 1) > 0.2) * rng.rand(h, w, 1),
                               rng.rand(h, w, 1)], axis=-1).astype(np.float32),
        "motion": rng.randn(h, w, 2),
    }


VIS_CALLS = {
    "overlay": lambda V, x: V.overlay(x["image"], x["probs"][:3].transpose(1, 2, 0) * 255, 0.3),
    "draw_sem_seg_probs": lambda V, x: V.draw_sem_seg(x["image"], x["probs"]),
    "draw_sem_seg_labels": lambda V, x: V.draw_sem_seg(x["image"], x["labels_map"]),
    "draw_text": lambda V, x: V._draw_text(x["image"], "traffic sign 97%", (50, 40)),
    "draw_text_at_the_edges": lambda V, x: V._draw_text(V._draw_text(V._draw_text(
        x["image"], "Wg|jq_y 100%", (-9, -4)), "bicycle", (90, 58)), "far", (200, 300)),
    "draw_panoptic": lambda V, x: V.draw_panoptic(x["image"], x["pan"], x["infos"]),
    "draw_panoptic_no_labels": lambda V, x: V.draw_panoptic(x["image"], x["pan"], x["infos"], draw_labels=False),
    "draw_instances": lambda V, x: V.draw_instances(x["image"], x["masks"], x["labels"], x["scores"],
                                                    boxes=x["boxes"]),
    "draw_instances_no_boxes": lambda V, x: V.draw_instances(x["image"], x["masks"], x["labels"], x["scores"]),
    "colorize_disparity": lambda V, x: V.colorize_disparity(x["disp"]),
    "colorize_disparity_constant": lambda V, x: V.colorize_disparity(np.full(HW, 0.2, np.float32)),
    "hsv_to_rgb": lambda V, x: V.hsv_to_rgb(x["hsv"]),
    "hsv_to_rgb_edges": lambda V, x: V.hsv_to_rgb(np.asarray([[0, 0, 0.5], [1, 1, 1], [1 / 6, 0.5, 0.5],
                                                              [0.5, 0, 0.2], [0.999999, 1, 1]], np.float32)),
    "flow_to_rgb": lambda V, x: V.flow_to_rgb(x["motion"]),
    "flow_to_rgb_zero": lambda V, x: V.flow_to_rgb(np.zeros(HW + (2,))),
}


@pytest.mark.parametrize("name", sorted(VIS_CALLS))
def test_visualizer_matches_jax(name):
    import uni_encoder_tpu.demo.visualizer as J
    import uni_encoder_tpu_torch.demo.visualizer as P

    x = _vis_inputs(np.random.RandomState(sorted(VIS_CALLS).index(name)))
    got, ref = VIS_CALLS[name](P, x), VIS_CALLS[name](J, x)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_magma_table_is_matplotlibs():
    from matplotlib import cm

    from uni_encoder_tpu_torch.demo.visualizer import magma_table

    np.testing.assert_array_equal(magma_table(), cm.magma(np.arange(256))[:, :3])


_NO_MATPLOTLIB = """
import sys
sys.modules["matplotlib"] = None
import numpy as np
from uni_encoder_tpu_torch.demo import visualizer as V
rng = np.random.RandomState(0)
assert V.colorize_disparity(rng.rand(8, 12).astype(np.float32)).shape == (8, 12, 3)
assert V.flow_to_rgb(rng.randn(8, 12, 2)).dtype == np.uint8
print(sorted(m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in ("matplotlib", "jax", "uni_encoder_tpu")))
"""


def test_visualizer_runs_without_matplotlib():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _NO_MATPLOTLIB], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stdout + proc.stderr


# ---------------------------------------------------------- prev frame
PREV_CASES = ["beside", "sequence_dir", "missing", "short_name", "not_a_frame"]


@pytest.mark.parametrize("case", PREV_CASES)
def test_prev_frame_path_matches_jax(case, tmp_path):
    import demo
    import demo_torch

    left = tmp_path / "leftImg8bit" / "val" / "city"
    seq = tmp_path / "leftImg8bit_sequence" / "val" / "city"
    left.mkdir(parents=True)
    seq.mkdir(parents=True)
    name = {"short_name": "city_000001.png", "not_a_frame": "city_000001_abc_leftImg8bit.png"}.get(
        case, "city_000001_000019_leftImg8bit.png")
    path = left / name
    path.touch()
    if case == "beside":
        (left / "city_000001_000017_leftImg8bit.png").touch()
    elif case == "sequence_dir":
        (seq / "city_000001_000017_leftImg8bit.png").touch()
    got = demo_torch.prev_frame_path(str(path))
    assert got == demo.prev_frame_path(str(path))
    assert (got is not None) == (case in ("beside", "sequence_dir"))
    assert demo_torch.prev_frame_path(str(path), offset=2) == demo.prev_frame_path(str(path), offset=2)


# --------------------------------------------------------- run_on_image
def _demo_config(C):
    """The scaled profile with 19 classes (the demo's thing ids are 11..18),
    in demo mode, segmenting at the frame's own size."""
    m = common.make_cfg(C)
    m = dataclasses.replace(m, is_demo=True, sem_seg_head=dataclasses.replace(m.sem_seg_head, num_classes=19),
                            test=dataclasses.replace(m.test, detections_per_image=common.NQ * 19))
    cfg = C.Config()
    return dataclasses.replace(cfg, model=m, input=dataclasses.replace(cfg.input, seg_min_size_test=HW[0],
                                                                       seg_max_size_test=2 * HW[1]))


def _frames(seed):
    """A frame and its previous frame: blocks of colour shifted by 4 pixels, with noise."""
    rng = np.random.RandomState(seed)
    scene = np.repeat(np.repeat(rng.randint(30, 226, (HW[0] // 8, HW[1] // 8 + 1, 3)), 8, 0), 8, 1)
    noise = lambda: rng.randint(-10, 11, HW + (3,))  # noqa: E731
    cur = np.clip(scene[:, 4:HW[1] + 4] + noise(), 0, 255).astype(np.uint8)
    prev = np.clip(scene[:, :HW[1]] + noise(), 0, 255).astype(np.uint8)
    return cur, prev


@pytest.fixture(scope="module")
def demos():
    """Both packages' VisualizationDemo on one random d2 state dict (class
    head x8, so segments and instances clear the 0.8 threshold)."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.demo.predictor import VisualizationDemo as JDemo
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.demo.predictor import VisualizationDemo
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    torch.set_num_threads(1)
    pcfg = _demo_config(TC)
    model = UniEncoder(pcfg.model, device="cpu")
    state = common.random_d2_state(model, seed=31)
    state["sem_seg_head.predictor.class_embed.weight"] *= 8.0
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return VisualizationDemo(pcfg, model), JDemo(_demo_config(JC), common.jax_variables(state))


class _JaxPredictions:
    """The JAX Predictor's outputs, handed to the port's demo."""

    def __init__(self, jpredictor):
        self.jpredictor = jpredictor
        self.device = torch.device("cpu")

    def infer_sequence(self, item):
        return self.jpredictor.infer_sequence(item)

    def infer_segmentation(self, item):
        return self.jpredictor.infer_segmentation(item)


RUNS = [("panoptic", True), ("semantic", False), ("instance", True)]


@pytest.fixture(scope="module")
def runs(demos):
    """{(task, with previous frame): (port outputs, JAX outputs, port
    outputs on the JAX predictions)}."""
    demo, jdemo = demos
    cur, prev = _frames(3)
    out = {}
    for task, with_prev in RUNS:
        p = prev if with_prev else None
        got = demo.run_on_image(cur, p, task)
        ref = jdemo.run_on_image(cur, p, task)
        own = demo.predictor
        demo.predictor = _JaxPredictions(jdemo.predictor)
        try:
            fed = demo.run_on_image(cur, p, task)
        finally:
            demo.predictor = own
        out[(task, with_prev)] = (got, ref, fed)
    return out


@pytest.mark.parametrize("task,with_prev", RUNS)
def test_run_on_image_renders_the_same_outputs(task, with_prev, runs):
    got, ref, _ = runs[(task, with_prev)]
    expected = {"panoptic": ["instance", "panoptic", "semantic"], "semantic": ["semantic"],
                "instance": ["instance"]}[task] + (list(SEQUENCE_RENDERINGS) if with_prev else [])
    assert sorted(got) == sorted(ref) == sorted(expected)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype == np.uint8 and got[k].shape == v.shape, k
        assert v.shape[:2] == (HW if k not in SEQUENCE_RENDERINGS else (192, 512)), k


FLOWS = {"ego_flow": (False, True), "independent_flow": (True, False), "total_flow": (True, True)}


@pytest.mark.parametrize("task,with_prev", RUNS)
def test_renderings_byte_equal_on_jax_predictions(task, with_prev, runs, demos):
    """The port's demo fed the JAX Predictor's outputs renders the JAX
    demo's bytes. The flow maps are the one computation between the
    predictions and the flow renderings: the port's `_flow_map` (torch) is
    within 1e-5 of the JAX one (jax.numpy), float32 rounding of the same
    products; the port's rendering of the JAX flow map is the JAX
    rendering's bytes. A flow map is a difference of two projections, so
    that rounding may move a pixel of a rendering of the port's own flow
    map by one level (ego flow: 0.1% of the pixels here)."""
    import uni_encoder_tpu.demo.predictor as JP
    import uni_encoder_tpu_torch.demo.predictor as PP
    from uni_encoder_tpu_torch.data.image_io import resize_lanczos
    from uni_encoder_tpu_torch.data.mappers import intrinsics_from_camera_json
    from uni_encoder_tpu_torch.geometry import disp_to_depth

    _, ref, fed = runs[(task, with_prev)]
    assert sorted(fed) == sorted(ref)
    for k, v in ref.items():
        if k in FLOWS:
            assert np.abs(fed[k].astype(np.int16) - v).max() <= 1, k
        else:
            np.testing.assert_array_equal(fed[k], v, err_msg=k)
    if not with_prev:
        return
    _, jdemo = demos
    cur, prev = _frames(3)
    seq = jdemo.predictor.infer_sequence({"image": resize_lanczos(cur, (192, 512)),
                                          "prev_image": resize_lanczos(prev, (192, 512))})
    depth = np.asarray(disp_to_depth(seq["disp_results"])[1])
    K, inv_K = intrinsics_from_camera_json(PP.DEFAULT_CAMERA, (192, 512))
    residual = seq["complete_flow"].transpose(2, 0, 1)
    for k, (motion, ego) in FLOWS.items():
        kw = dict(motion=residual if motion else None, cam_T_cam=seq["cam_T_cam"] if ego else None)
        jflow = JP._flow_map(depth, K, inv_K, **kw)
        np.testing.assert_allclose(PP._flow_map(depth, K, inv_K, **kw), jflow, rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(PP.vis.flow_to_rgb(jflow), ref[k], err_msg=k)


@pytest.mark.parametrize("task,with_prev", RUNS)
def test_run_on_image_end_to_end_matches_jax(task, with_prev, runs):
    got, ref, _ = runs[(task, with_prev)]
    for k, v in ref.items():
        differ = (got[k] != v).any(axis=-1) if v.ndim == 3 else got[k] != v
        assert differ.mean() <= PIXEL_SHARE, (k, differ.mean())


def test_sequence_pass_matches_jax(demos):
    """The sequence pass's inputs (PIL-exact Lanczos to 192x512) are equal,
    and its outputs within SEQ_ATOL."""
    from PIL import Image

    from uni_encoder_tpu_torch.data.image_io import resize_lanczos

    demo, jdemo = demos
    cur, prev = _frames(3)
    items = {}
    for k, img in (("image", cur), ("prev_image", prev)):
        items[k] = resize_lanczos(img, (192, 512))
        np.testing.assert_array_equal(items[k], np.asarray(Image.fromarray(img).resize((512, 192), Image.LANCZOS)))
    got, ref = demo.predictor.infer_sequence(items), jdemo.predictor.infer_sequence(items)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **SEQ)


# ------------------------------------------------------------ entry point
_MAIN = """
import json, sys
sys.modules["matplotlib"] = None
import demo_torch
timings = []
written = demo_torch.main(sys.argv[1:], timings=timings)
print(json.dumps({"written": written, "timings": timings,
                  "bad": sorted(m for m, v in sys.modules.items()
                                if v is not None and m.split(".")[0] in ("matplotlib", "jax", "uni_encoder_tpu"))}))
"""


def test_demo_main_writes_every_directory(tmp_path):
    """`demo_torch.main --device cpu` in a fresh interpreter with matplotlib
    unimportable, on two Cityscapes frames (one with its t-2 frame in
    leftImg8bit_sequence, one without) and a .pth of the scaled model."""
    import json

    from uni_encoder_tpu_torch.data import synthetic
    from uni_encoder_tpu_torch.data.image_io import read_image
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    root = str(tmp_path / "data")
    synthetic.write_cityscapes_sequence(root, 2, HW, depth_hw=(8, 8))
    test_dir = os.path.join(root, "cityscapes_crop", "leftImg8bit_sequence", "test", synthetic.CITY)
    os.remove(os.path.join(test_dir, f"{synthetic.CITY}_000001_000017_leftImg8bit.png"))
    cfg_path = tmp_path / "demo.yaml"
    cfg_path.write_text(DEMO_CONFIG)
    from uni_encoder_tpu_torch.config import load_config

    model = UniEncoder(load_config(str(cfg_path)).model, device="cpu")
    torch.save({"model": model.state_dict()}, str(tmp_path / "model.pth"))
    out = tmp_path / "out"
    pattern = os.path.join(root, "cityscapes_crop", "leftImg8bit", "test", synthetic.CITY, "*.png")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _MAIN, "--input", pattern, "--output", str(out), "--device", "cpu",
                           "--config", str(cfg_path), "--weights", str(tmp_path / "model.pth")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    first, second = sorted(res["written"])
    assert sorted(res["written"][first]) == sorted(["instance", "panoptic", "semantic", *SEQUENCE_RENDERINGS])
    assert sorted(res["written"][second]) == ["instance", "panoptic", "semantic"]
    assert sorted(os.listdir(out)) == sorted(res["written"][first])
    for name, path in res["written"][first].items():
        assert path == os.path.join(str(out), name, os.path.basename(first))
        assert read_image(path).shape == ((192, 512, 3) if name in SEQUENCE_RENDERINGS else HW + (3,)), name
    assert [t["image"] for t in res["timings"]] == [first, second]
    assert all(t["predict_s"] > 0 and t["render_s"] > 0 for t in res["timings"])


DEMO_CONFIG = f"""
model:
  backbone:
    name: swin
    swin:
      embed_dim: {common.EMBED}
      depths: {list(common.DEPTHS)}
      num_heads: {list(common.HEADS)}
  sem_seg_head:
    num_classes: 19
    convs_dim: {common.CONV_DIM}
    mask_dim: {common.CONV_DIM}
    transformer_enc_layers: {common.ENC_LAYERS}
  one_former:
    num_object_queries: {common.NQ}
    dec_layers: {common.DEC_LAYERS}
    class_dec_layers: 2
    dim_feedforward: {common.DFF}
    hidden_dim: {common.CONV_DIM}
    nheads: {common.NHEADS}
input:
  seg_min_size_test: {HW[0]}
  seg_max_size_test: {2 * HW[1]}
"""


def test_demo_main_needs_a_gpu_unless_told_cpu(tmp_path, monkeypatch):
    import demo_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_torch.main(["--input", str(tmp_path / "*.png"), "--output", str(tmp_path / "out")])
