"""The port imports neither jax/flax nor anything of the JAX package, and
neither PIL, cv2 nor matplotlib when it is imported.

tests/conftest.py imports jax for every test, so the import check runs in a
fresh interpreter; a source scan backs it up for imports that only run
inside functions. The port's sources, `evaluate_torch.py`, `train_torch.py`,
`demo_torch.py`, `tools/convert_checkpoint_torch.py`,
`tools/calc_throughput_torch.py`, `tools/analyze_model_torch.py`,
`tools/k4_compare_torch.py`, `tools/dryrun_multichip_torch.py`, `chip_smoke.py` and `k5_variants.py` are checked. PIL and cv2 are imported inside functions in
named places only (CALL_TIME_IMPORTS: JPEG files, the demo's text labels,
COCO polygons), matplotlib nowhere, and the train mappers import neither
PIL nor cv2 when they run.
"""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "uni_encoder_tpu_torch")

_CHECK = """
import importlib, pkgutil, sys
import uni_encoder_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, "uni_encoder_tpu_torch."):
    importlib.import_module(m.name)
assert "uni_encoder_tpu_torch.parallel.spatial" in sys.modules
import chip_smoke
import demo_torch
import evaluate_torch
import k5_variants
import train_torch
sys.path.insert(0, "tools")
import analyze_model_torch
import calc_throughput_torch
import convert_checkpoint_torch
import dryrun_multichip_torch
import k4_compare_torch
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "jaxlib", "uni_encoder_tpu", "PIL", "cv2", "matplotlib"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "evaluate_torch.py")
    yield os.path.join(REPO, "train_torch.py")
    yield os.path.join(REPO, "k5_variants.py")
    yield os.path.join(REPO, "demo_torch.py")
    yield os.path.join(REPO, "tools", "convert_checkpoint_torch.py")
    yield os.path.join(REPO, "tools", "calc_throughput_torch.py")
    yield os.path.join(REPO, "tools", "analyze_model_torch.py")
    yield os.path.join(REPO, "tools", "k4_compare_torch.py")
    yield os.path.join(REPO, "tools", "dryrun_multichip_torch.py")


# the only places that import PIL or cv2, each inside the function that needs it
CALL_TIME_IMPORTS = {
    os.path.join("uni_encoder_tpu_torch", "data", "image_io.py"): {"PIL"},  # JPEG read / write
    os.path.join("uni_encoder_tpu_torch", "demo", "visualizer.py"): {"PIL"},  # text labels (_draw_text)
    os.path.join("uni_encoder_tpu_torch", "evaluation", "coco.py"): {"cv2"},  # polygon masks (_poly_to_mask)
}


def test_source_scan_finds_no_jax_package_import():
    jax_pkg = re.compile(r"^\s*(from|import)\s+uni_encoder_tpu(?!_torch)\b", re.M)
    jax_lib = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax)\b", re.M)
    found = []
    for path in _sources():
        with open(path) as f:
            src = f.read()
        for pat in (jax_pkg, jax_lib):
            found += [f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}" for m in pat.finditer(src)]
    assert not found, found


def test_source_scan_finds_no_module_level_pil_or_cv2_import():
    """PIL and cv2 are imported only inside functions, and only where
    CALL_TIME_IMPORTS names them: PNG files and resizes go through
    `data/image_io.py`, JPEG files through PIL there, the demo's labels
    through PIL and COCO polygons through cv2. matplotlib is imported
    nowhere."""
    top_level = re.compile(r"^(from|import)\s+(PIL|cv2|matplotlib)\b", re.M)
    anywhere = re.compile(r"^\s*(from|import)\s+(PIL|cv2|matplotlib)\b", re.M)
    found = []
    for path in _sources():
        with open(path) as f:
            src = f.read()
        rel = os.path.relpath(path, REPO)
        found += [f"{rel}: {m.group(0).strip()}" for m in top_level.finditer(src)]
        found += [f"{rel}: {m.group(0).strip()}" for m in anywhere.finditer(src)
                  if m.group(2) not in CALL_TIME_IMPORTS.get(rel, ())]
    assert not found, found


def test_walk_covers_the_training_modules():
    """The import check above walks the training slice's modules too (the
    training package, the text encoder, the backward kernel's source), the
    evaluation path's (checkpoints, data, evaluators, host helpers) and the
    data-parallel ones (`parallel/`, the profiling helpers)."""
    import pkgutil

    import uni_encoder_tpu_torch as port

    names = {m.name for m in pkgutil.walk_packages(port.__path__, "uni_encoder_tpu_torch.")}
    for mod in ("training.train_step", "training.criterion", "training.matcher", "training.monodepth",
                "models.text_transformer", "ops.ms_deform_attn", "engine.convert", "engine.checkpoint",
                "engine.tta", "data.image_io", "data.mappers", "data.build", "data.datasets.kitti",
                "evaluation.cityscapes", "evaluation.kitti", "native", "data.train_mappers", "data.color",
                "engine.events", "parallel.mesh", "parallel.launch", "utils.profiling"):
        assert f"uni_encoder_tpu_torch.{mod}" in names, mod
    assert os.path.exists(os.path.join(PORT, "kernels", "csrc", "ms_deform_attn_backward.cu"))


def test_walk_covers_the_backbones():
    """The import check walks the ResNet, ConvNeXt and DiNAT backbones and
    the neighborhood-attention op, and K4's source is listed for the build."""
    import pkgutil

    import uni_encoder_tpu_torch as port
    from uni_encoder_tpu_torch import kernels

    names = {m.name for m in pkgutil.walk_packages(port.__path__, "uni_encoder_tpu_torch.")}
    for mod in ("models.backbones.resnet", "models.backbones.convnext", "models.backbones.dinat",
                "ops.neighborhood_attention"):
        assert f"uni_encoder_tpu_torch.{mod}" in names, mod
    assert "neighborhood_attention" in kernels.SOURCES
    assert os.path.exists(os.path.join(PORT, "kernels", "csrc", "neighborhood_attention.cu"))


_MAPPERS = """
import sys, tempfile
from uni_encoder_tpu_torch.data import datasets, synthetic
from uni_encoder_tpu_torch.data.catalog import DatasetCatalog
from uni_encoder_tpu_torch.data.train_mappers import SegmentationTrainMapper, SequenceTrainMapper
import train_torch
with tempfile.TemporaryDirectory() as root:
    synthetic.write_cityscapes_train(root, 1, (64, 128))
    datasets.register_all(root)
    seg = SegmentationTrainMapper(crop_size=(64, 128), min_sizes=(96,), max_size=256, num_texts=4)
    seg(DatasetCatalog.get("cityscapes_fine_panoptic_train")[0])
    SequenceTrainMapper(hw=(32, 64))(DatasetCatalog.get("cityscapes_sequence_crop_full_sequence_train")[0])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "jaxlib", "uni_encoder_tpu", "PIL", "cv2"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_train_mappers_run_without_pil_or_cv2():
    """One call of each train mapper, in a fresh interpreter, imports
    neither PIL nor cv2 (nor anything of JAX)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _MAPPERS], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_walk_covers_the_demo_and_the_ade20k_coco_modules():
    """The import check walks the demo, the ADE20K / COCO registrations,
    the prep helpers and the COCO evaluator; the source scans read the demo
    and conversion entry points."""
    import pkgutil

    import uni_encoder_tpu_torch as port

    names = {m.name for m in pkgutil.walk_packages(port.__path__, "uni_encoder_tpu_torch.")}
    for mod in ("demo.predictor", "demo.visualizer", "data.prep", "data.datasets.ade20k", "data.datasets.coco",
                "evaluation.coco"):
        assert f"uni_encoder_tpu_torch.{mod}" in names, mod
    sources = {os.path.relpath(p, REPO) for p in _sources()}
    assert {"demo_torch.py", os.path.join("tools", "convert_checkpoint_torch.py")} <= sources
    assert set(CALL_TIME_IMPORTS) <= sources
