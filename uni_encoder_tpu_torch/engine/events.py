"""Metrics storage and writers (observability); the port's own copy of
`uni_encoder_tpu/engine/events.py`, so `metrics.json` holds the same
records. One change: MLflowWriter uploads the checkpoint file that
`last_checkpoint` names (`engine/checkpoint.py`'s layout), where the JAX
copy looks for a `checkpoint` path its own checkpoints do not write.

Capability spec: reference model/utils/events.py + d2 EventStorage —
CommonMetricPrinter / JSONWriter (metrics.json) / MLflowWriter (metrics +
artifacts + periodic checkpoint upload) / WandbWriter, plus setup_mlflow /
setup_wandb bootstrap (zips the source tree as a run artifact). mlflow and
wandb are optional imports; writers gate themselves off when absent.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


class EventStorage:
    def __init__(self, start_iter: int = 0):
        self.iter = start_iter
        self._history: Dict[str, List] = defaultdict(list)
        self._latest: Dict[str, tuple] = {}

    def put_scalar(self, name: str, value) -> None:
        value = float(value)
        self._history[name].append((self.iter, value))
        self._latest[name] = (self.iter, value)

    def put_scalars(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def latest(self) -> Dict[str, tuple]:
        return dict(self._latest)

    def step(self) -> None:
        self.iter += 1


class EventWriter:
    def write(self, storage: EventStorage) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CommonMetricPrinter(EventWriter):
    def __init__(self, max_iter: Optional[int] = None):
        self.max_iter = max_iter
        self._t0 = time.time()

    def write(self, storage: EventStorage) -> None:
        parts = [f"iter {storage.iter}"]
        if self.max_iter:
            parts[0] += f"/{self.max_iter}"
        for k, (_, v) in sorted(storage.latest().items()):
            parts.append(f"{k}: {v:.4g}")
        logger.info("  ".join(parts))


class JSONWriter(EventWriter):
    def __init__(self, json_file: str):
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self._f = open(json_file, "a")

    def write(self, storage: EventStorage) -> None:
        rec = {"iteration": storage.iter}
        rec.update({k: v for k, (_, v) in storage.latest().items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class MLflowWriter(EventWriter):
    """Gated on mlflow availability (reference utils/events.py:179-255)."""

    def __init__(self, checkpoint_dir: Optional[str] = None, checkpoint_period: int = 5000):
        try:
            import mlflow  # noqa: F401

            self._mlflow = mlflow
        except ImportError:
            self._mlflow = None
            logger.warning("mlflow not available; MLflowWriter disabled")
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_period = checkpoint_period

    def write(self, storage: EventStorage) -> None:
        if self._mlflow is None:
            return
        self._mlflow.log_metrics(
            {k.replace("/", "_"): v for k, (_, v) in storage.latest().items()}, step=storage.iter
        )
        if (
            self.checkpoint_dir
            and storage.iter > 0
            and storage.iter % self.checkpoint_period == 0
        ):
            pointer = os.path.join(self.checkpoint_dir, "last_checkpoint")
            if os.path.isfile(pointer):
                with open(pointer) as f:
                    ckpt = os.path.join(self.checkpoint_dir, f.read().strip())
                if os.path.isfile(ckpt):
                    self._mlflow.log_artifact(ckpt)


class WandbWriter(EventWriter):
    def __init__(self):
        try:
            import wandb

            self._wandb = wandb
        except ImportError:
            self._wandb = None
            logger.warning("wandb not available; WandbWriter disabled")

    def write(self, storage: EventStorage) -> None:
        if self._wandb is None or self._wandb.run is None:
            return
        self._wandb.log({k: v for k, (_, v) in storage.latest().items()}, step=storage.iter)


def setup_mlflow(experiment: str, run_name: str, source_dir: Optional[str] = None):
    """Bootstrap an mlflow run; zips the source tree as an artifact
    (reference events.py:68-85). No-op if mlflow is missing."""
    try:
        import mlflow
    except ImportError:
        logger.warning("mlflow not available; skipping setup")
        return None
    mlflow.set_experiment(experiment)
    run = mlflow.start_run(run_name=run_name)
    if source_dir:
        import shutil
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            archive = shutil.make_archive(os.path.join(td, "source"), "zip", source_dir)
            mlflow.log_artifact(archive)
    return run


def setup_wandb(project: str, name: str, config: Optional[dict] = None):
    try:
        import wandb
    except ImportError:
        logger.warning("wandb not available; skipping setup")
        return None
    return wandb.init(project=project, name=name, config=config or {})
