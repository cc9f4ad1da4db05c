"""The port's entry points against the JAX package's, on the CPU in fp32 at
the scaled profile (tests/_torch_port_common.py): Predictor.infer_segmentation
and Predictor.infer_sequence from uint8 images, and the AsyncBatchedPredictor
serving pool (the behaviour tests/test_engine_extras.py asserts of the JAX
pool, plus tail padding and error propagation).

Tolerances: infer_sequence SEQ_ATOL 1e-5 / rtol 1e-4; infer_segmentation as
stated in its test.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import _torch_port_common as common

SEQ = dict(atol=common.SEQ_ATOL, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ Predictor
@pytest.fixture(scope="module")
def predictors():
    """Both Predictors on one random d2 state dict (class head scaled up so
    that panoptic segments and instances survive the 0.8 threshold)."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.engine.predictor import Predictor as JPredictor
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.engine.predictor import Predictor

    def config(C):
        # the instance top-k takes at most Q * K = 56 class scores here
        cfg = common.make_cfg(C)
        cfg = dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, detections_per_image=common.NQ * common.K))
        return dataclasses.replace(C.Config(), model=cfg)

    torch.set_num_threads(1)
    model, _, variables, _ = common.model_pair(seed=11)
    jpred = JPredictor(config(JC), variables)
    pred = Predictor(config(TC), model)
    things = list(range(common.K // 2, common.K))
    jpred.set_thing_ids(things)
    pred.set_thing_ids(things)
    return pred, jpred


def test_predictor_infer_sequence_matches_jax(predictors):
    pred, jpred = predictors
    rng = np.random.RandomState(8)
    item = {"image": rng.randint(0, 256, (64, 128, 3), np.uint8),
            "prev_image": rng.randint(0, 256, (64, 128, 3), np.uint8)}
    ref = jpred.infer_sequence(item)
    got = pred.infer_sequence(item)
    assert sorted(got) == ["cam_T_cam", "complete_flow", "disp_results", "motion_mask"]
    for k, v in ref.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, err_msg=k, **SEQ)


def test_predictor_infer_segmentation_matches_jax(predictors):
    """A 100x150 uint8 image (padded to 128x160 inside) answered at 120x180.
    Semantic argmax map exact and probabilities at SEG_ATOL; panoptic map
    and segments equal; instance labels equal and scores at 1e-3."""
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task

    pred, jpred = predictors
    rng = np.random.RandomState(9)
    item = {"image": rng.randint(0, 256, (100, 150, 3), np.uint8), "height": 120, "width": 180,
            "task_tokens": np.asarray(tokenize_task("The task is panoptic"), np.int32)}
    ref = jpred.infer_segmentation(item)
    got = pred.infer_segmentation(item)
    assert sorted(got) == sorted(ref) == ["instances", "panoptic_seg", "sem_seg"]

    assert got["sem_seg"].shape == (common.K, 120, 180) and got["sem_seg"].dtype == np.float32
    np.testing.assert_array_equal(got["sem_seg"].argmax(0), ref["sem_seg"].argmax(0))
    np.testing.assert_allclose(got["sem_seg"], ref["sem_seg"], atol=common.SEG_ATOL, rtol=1e-3)

    pan, infos = got["panoptic_seg"]
    assert pan.dtype == np.int32 and pan.shape == (120, 180)
    assert infos, "no panoptic segment kept: the fixture should keep some"
    np.testing.assert_array_equal(pan, ref["panoptic_seg"][0])
    assert infos == ref["panoptic_seg"][1]

    inst, jinst = got["instances"], ref["instances"]
    assert sorted(inst) == sorted(jinst)
    assert len(inst["labels"]) > 0 and set(inst["labels"]) <= set(range(common.K // 2, common.K))
    np.testing.assert_array_equal(inst["labels"], jinst["labels"])
    np.testing.assert_array_equal(inst["query_indices"], jinst["query_indices"])
    np.testing.assert_allclose(inst["scores"], jinst["scores"], atol=1e-3, rtol=1e-3)
    assert (inst["masks"] != jinst["masks"]).mean() < 1e-3


def test_predictor_ade20k_remap_drops_stuff(predictors):
    """ADE20K mode re-indexes instance labels into the thing list; the
    panoptic thing filter runs first, so no -1 survives."""
    pred, _ = predictors
    things = [1, 4, 6]
    pred.set_thing_ids(things, dataset_name="ade20k_panoptic_val")
    try:
        assert pred.instance_label_remap.tolist() == [-1, 0, -1, -1, 1, -1, 2]
        rng = np.random.RandomState(10)
        from uni_encoder_tpu_torch.data.tokenizer import tokenize_task

        out = pred.infer_segmentation({"image": rng.randint(0, 256, (64, 96, 3), np.uint8),
                                       "task_tokens": np.asarray(tokenize_task("The task is instance"))})
        assert ((out["instances"]["labels"] >= 0) & (out["instances"]["labels"] < len(things))).all()
    finally:
        pred.set_thing_ids(list(range(common.K // 2, common.K)))


# --------------------------------------------------------------------- serving
def test_async_batched_predictor_orders_results():
    """tests/test_engine_extras.py's check of the JAX pool, on the port's."""
    from uni_encoder_tpu_torch.engine.serving import AsyncBatchedPredictor

    pred = AsyncBatchedPredictor(lambda batch: {"y": batch["x"] * 2}, batch_size=4, device="cpu",
                                 max_wait_s=0.01)
    try:
        futs = [pred.submit({"x": np.full((3,), i, np.float32)}) for i in range(10)]
        outs = [f.result(timeout=30) for f in futs]
    finally:
        pred.shutdown()
    for i, o in enumerate(outs):
        assert isinstance(o["y"], np.ndarray)
        np.testing.assert_allclose(o["y"], 2.0 * i)


def test_async_batched_predictor_pads_tail_with_last_item():
    from uni_encoder_tpu_torch.engine.serving import AsyncBatchedPredictor

    seen = []
    gate = threading.Event()

    def fn(batch):
        gate.wait(timeout=30)
        seen.append(batch["x"].tolist())
        return {"y": batch["x"] + 1, "pair": (batch["x"], batch["x"].to(torch.bfloat16))}

    pred = AsyncBatchedPredictor(fn, batch_size=4, device="cpu", max_wait_s=0.5)
    try:
        futs = [pred.submit({"x": i}) for i in range(6)]
        gate.set()
        outs = [f.result(timeout=30) for f in futs]
    finally:
        pred.shutdown()
    assert seen == [[0, 1, 2, 3], [4, 5, 5, 5]]
    assert [int(o["y"]) for o in outs] == [1, 2, 3, 4, 5, 6]
    assert outs[5]["pair"][1].dtype == np.float32 and float(outs[5]["pair"][1]) == 5.0
    assert not pred._thread.is_alive()


def test_async_batched_predictor_sets_exception_on_every_pending_future():
    from uni_encoder_tpu_torch.engine.serving import AsyncBatchedPredictor

    def fn(batch):
        if int(batch["x"][0]) == 0:
            raise ValueError("bad batch")
        return {"y": batch["x"]}

    pred = AsyncBatchedPredictor(fn, batch_size=2, device="cpu", max_wait_s=0.5)
    try:
        futs = [pred.submit({"x": i}) for i in range(4)]
        for f in futs[:2]:
            with pytest.raises(ValueError, match="bad batch"):
                f.result(timeout=30)
        # the pool keeps serving after a failed batch
        assert [int(f.result(timeout=30)["y"]) for f in futs[2:]] == [2, 3]
    finally:
        pred.shutdown()


def test_per_item_serves_a_predictor_method():
    """per_item turns a one-item entry point into the pool's batched fn:
    each future gets its own item's result, padding items are dropped."""
    from uni_encoder_tpu_torch.engine.serving import AsyncBatchedPredictor, per_item

    calls = []

    def infer(item):
        calls.append(item["image"].shape)
        return {"sum": int(item["image"].sum()), "info": [{"id": int(item["k"])}]}

    pred = AsyncBatchedPredictor(per_item(infer), batch_size=2, device="cpu", max_wait_s=0.5)
    try:
        futs = [pred.submit({"image": np.full((2, 3), k, np.uint8), "k": k}) for k in range(3)]
        outs = [f.result(timeout=30) for f in futs]
    finally:
        pred.shutdown()
    assert outs == [{"sum": 6 * k, "info": [{"id": k}]} for k in range(3)]
    assert calls == [(2, 3)] * 4


def test_async_batched_predictor_shutdown_resolves_every_future():
    """Shutdown while the pool fills a batch (batch 4, one item submitted,
    max_wait_s 1 s): the sentinel ends the batch instead of joining it, the
    item is served (or, if the loop had not taken it yet, failed) within
    3 s, the loop ends, and a later submit raises."""
    import time

    from uni_encoder_tpu_torch.engine.serving import AsyncBatchedPredictor

    pred = AsyncBatchedPredictor(lambda batch: {"y": batch["x"] * 2}, batch_size=4, device="cpu", max_wait_s=1.0)
    fut = pred.submit({"x": np.float32(3)})
    time.sleep(0.2)  # the loop holds the item and waits for three more
    pred.shutdown()
    try:
        assert float(fut.result(timeout=3)["y"]) == 6.0
    except RuntimeError as e:
        assert "shut down" in str(e)
    assert not pred._thread.is_alive()
    with pytest.raises(RuntimeError, match="shutdown"):
        pred.submit({"x": np.float32(1)})


def test_async_batched_predictor_shutdown_fails_queued_items():
    """Items still queued behind a running batch at shutdown get an
    exception; the batch in hand is served."""
    import time

    from uni_encoder_tpu_torch.engine.serving import AsyncBatchedPredictor

    gate, running = threading.Event(), threading.Event()

    def fn(batch):
        running.set()
        gate.wait(timeout=30)
        return {"y": batch["x"]}

    pred = AsyncBatchedPredictor(fn, batch_size=1, device="cpu", max_wait_s=0.01)
    futs = [pred.submit({"x": i}) for i in range(3)]
    assert running.wait(timeout=10)
    stopper = threading.Thread(target=pred.shutdown)
    stopper.start()
    deadline = time.monotonic() + 10
    while not pred._closed and time.monotonic() < deadline:
        time.sleep(0.01)
    with pred._lock:  # shutdown fails the queued items under this lock
        pass
    gate.set()
    stopper.join(timeout=10)
    assert int(futs[0].result(timeout=3)["y"]) == 0
    for f in futs[1:]:
        with pytest.raises(RuntimeError, match="shut down"):
            f.result(timeout=3)
