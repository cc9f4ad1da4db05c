"""Serving pool: asynchronous batched inference (port of
`uni_encoder_tpu/engine/serving.py`).

Requests are queued, grouped by a background thread into fixed-size batches
(the tail padded by repeating its last item), stacked on the device and run
by one batched forward; results come back through futures in submission
order. `per_item` turns a one-item entry point such as
`Predictor.infer_segmentation` into the batched function the pool takes.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from ..device import resolve_device


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def per_item(infer: Callable[[Dict], Any]) -> Callable[[Dict], np.ndarray]:
    """`infer` (one item -> one result) as a batched function: it runs on
    each item of the stacked batch in turn and returns the results as a
    one-dimensional object array, a leaf with a leading batch axis."""

    def fn(batch: Dict[str, torch.Tensor]) -> np.ndarray:
        n = len(next(iter(batch.values())))
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = infer({k: v[i] for k, v in batch.items()})
        return out

    return fn


class AsyncBatchedPredictor:
    """Wraps a batched forward `fn(batch_dict) -> batch_outputs`, where every
    leaf of the outputs (tensors or arrays, in dicts, lists or tuples) has a
    leading batch axis. Submissions return futures; a background thread
    stacks `batch_size` items on `device` (None = the GPU, raising without
    one), padding a short tail by repeating its last item, and hands each
    future its slice of the outputs as numpy arrays. If `fn` raises, every
    pending future of that batch gets the exception.

    `shutdown()` stops the pool: every item still queued gets a
    RuntimeError, the batch in hand is served, and `submit` raises from then
    on, so no future is left pending. (The JAX copy's loop read its stop
    sentinel as an item when it came while a batch was filling, and died.)"""

    def __init__(self, fn: Callable, batch_size: int, device: Optional[Union[str, torch.device]] = None,
                 max_wait_s: float = 0.005):
        self.fn = fn
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.max_wait_s = max_wait_s
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()  # orders submissions against the sentinel
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item: dict) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("submit after shutdown: the serving pool is stopped")
            self._q.put((item, fut))
        return fut

    def __call__(self, item: dict):
        return self.submit(item).result()

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
            self._fail_queued()
            self._q.put(None)
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------
    def _fail_queued(self) -> None:
        """Fail every item the loop has not taken yet."""
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                return
            fut.set_exception(RuntimeError("the serving pool was shut down before this item ran"))

    def _loop(self) -> None:
        stop = False
        while not stop:
            first = self._q.get()
            if first is None:
                return
            batch = [first]
            try:
                while len(batch) < self.batch_size:
                    entry = self._q.get(timeout=self.max_wait_s)
                    if entry is None:  # shutdown while the batch filled: serve what is in hand
                        stop = True
                        break
                    batch.append(entry)
            except queue.Empty:
                pass
            self._serve(batch)

    def _serve(self, batch) -> None:
        items = [b[0] for b in batch]
        futs = [b[1] for b in batch]
        n = len(items)
        # a fixed batch shape: the padding costs part of the last batch only
        items += [items[-1]] * (self.batch_size - n)
        try:
            stacked = {k: torch.stack([torch.as_tensor(it[k]) for it in items]).to(self.device)
                       for k in items[0]}
            out = _tree_map(_host, self.fn(stacked))
            for i, fut in enumerate(futs[:n]):
                fut.set_result(_tree_map(lambda x: x[i], out))
        except Exception as e:  # a failed batch must not stop the pool
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)
