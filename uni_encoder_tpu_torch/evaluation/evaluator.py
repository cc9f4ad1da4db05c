"""Evaluator protocol + inference loop (the port's counterpart of
`uni_encoder_tpu/evaluation/evaluator.py`).

Capability spec: reference model/evaluation/evaluator.py (:19-228):
DatasetEvaluator with reset/process/evaluate, the DatasetEvaluators
fan-out, and an inference loop with periodic ETA logging. Distribution: in
a torch.distributed process group (`parallel/mesh.py`) each rank evaluates
its shard of the dataset (`data/build.py::inference_shard`), and
`inference_on_dataset` gathers every evaluator's accumulated state from
all ranks (`allgather_object`) and merges them before summarizing, so every
rank reports the dataset-level metrics (the reference gathers per-rank
state with comm.gather).
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


def allgather_object(obj: Any) -> List[Any]:
    """Every rank's picklable `obj`, in rank order
    (`torch.distributed.all_gather_object`); `[obj]` without a process
    group."""
    from ..parallel import mesh

    if not mesh.active():
        return [obj]
    import torch.distributed as dist

    out: List[Any] = [None] * mesh.world()
    dist.all_gather_object(out, obj)
    return out


class DatasetEvaluator:
    def reset(self):
        pass

    def process(self, inputs: List[dict], outputs: List[dict]):
        pass

    def evaluate(self) -> Optional[Dict]:
        pass

    # ------------------------------------------------- sharded evaluation
    def state(self) -> Any:
        """The picklable accumulated state (each concrete evaluator's)."""
        raise NotImplementedError(type(self).__name__)

    def merge_state(self, states: List[Any]) -> None:
        """Replace this evaluator's state by the union of the shards'
        `states` (its own among them), in rank order."""
        raise NotImplementedError(type(self).__name__)

    def merge_across_processes(self) -> None:
        """Merge every rank's state into each rank's (nothing without a
        process group)."""
        from ..parallel import mesh

        if mesh.active():
            self.merge_state(allgather_object(self.state()))


class DatasetEvaluators(DatasetEvaluator):
    def __init__(self, evaluators: List[DatasetEvaluator]):
        self._evaluators = evaluators

    def reset(self):
        for e in self._evaluators:
            e.reset()

    def process(self, inputs, outputs):
        for e in self._evaluators:
            e.process(inputs, outputs)

    def state(self):
        return [e.state() for e in self._evaluators]

    def merge_state(self, states):
        for i, e in enumerate(self._evaluators):
            e.merge_state([s[i] for s in states])

    def evaluate(self):
        results: Dict = {}
        for e in self._evaluators:
            r = e.evaluate()
            if r:
                for k, v in r.items():
                    if k in results:
                        raise ValueError(f"duplicate metric key {k}")
                    results[k] = v
        return results


def inference_on_dataset(run_model: Callable, data_loader, evaluator: DatasetEvaluator,
                         timings: Optional[List[Dict[str, float]]] = None) -> Dict:
    """run_model(item) -> output dict; batch size 1 like the reference's
    eval loop (build.py:113). With `timings`, appends for each item the
    seconds spent waiting for the loader, in `run_model` and in the
    evaluator's `process`, and the number of instances and panoptic
    segments the output handed the evaluator (where it has them), on
    which the cost of `process` depends."""
    evaluator.reset()
    total = len(data_loader)
    start = time.perf_counter()
    last_log = start
    it = iter(data_loader)
    i = 0
    while True:
        t0 = time.perf_counter()
        item = next(it, None)
        if item is None:
            break
        t1 = time.perf_counter()
        out = run_model(item)
        t2 = time.perf_counter()
        evaluator.process([item], [out])
        now = time.perf_counter()
        if timings is not None:
            timings.append({"loader_wait_s": t1 - t0, "predict_s": t2 - t1, "process_s": now - t2})
            if "instances" in out:
                timings[-1]["instances"] = len(out["instances"]["scores"])
            if "panoptic_seg" in out:
                timings[-1]["segments"] = len(out["panoptic_seg"][1])
        if now - last_log > 5.0:
            per_img = (now - start) / (i + 1)
            eta = datetime.timedelta(seconds=int(per_img * (total - i - 1)))
            logger.info(f"inference {i+1}/{total} ({per_img:.3f} s/img, ETA {eta})")
            last_log = now
        i += 1
    # each rank evaluated its shard (data/build.py): merge the shards' states
    # so the metrics are the dataset's
    evaluator.merge_across_processes()
    results = evaluator.evaluate()
    total_t = time.perf_counter() - start
    logger.info(f"inference done: {total} images in {total_t:.1f}s ({total / max(total_t,1e-9):.2f} img/s)")
    return results or {}
