"""The port's segmentation serving slice against the JAX package, on the CPU:
tokenizer ids, the weight carry-across, the plain version of the fused
post-process (K1) against the JAX kernel in interpret mode, and the whole
forward_segmentation + post-process at the scaled profile."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_port_common as common
from _torch_port_common import t


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def slice_pair():
    """Both packages on one random d2 state dict (class head scaled up)."""
    torch.set_num_threads(1)
    return common.model_pair(seed=7)


@pytest.mark.parametrize("task", ["The task is panoptic", "The task is semantic", "The task is instance"])
def test_tokenizer_ids_match_jax(task):
    from uni_encoder_tpu.data.tokenizer import tokenize_task as jtok
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task as ttok

    assert ttok(task) == jtok(task)
    assert len(ttok(task)) == 77


def test_tokenizer_known_ids():
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task

    assert tokenize_task("The task is panoptic")[:8] == (49406, 518, 10549, 533, 1072, 24755, 49407, 0)


@pytest.mark.parametrize("case", ["exact", "stray_predictor_leaf", "stray_sequence_leaf", "stray_batch_stat"])
def test_convert_round_trip(slice_pair, case):
    """d2 state dict -> JAX Converter -> flax params and batch_stats ->
    state_dict_from_jax gives back the original exactly, sequence subtrees
    and BatchNorm statistics included, and loads strictly into the port. A
    stray leaf, in the segmentation or the sequence subtrees or in
    batch_stats, raises."""
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax

    model, _, variables, state = slice_pair
    params, stats = dict(variables["params"]), dict(variables["batch_stats"])
    stray = {"kernel": np.zeros((2, 2), np.float32)}
    if case == "exact":
        sd = state_dict_from_jax(params, stats)
        assert sorted(sd) == sorted(state)
        assert any(k.endswith("running_var") for k in sd) and any(k.startswith("motion_mask.") for k in sd)
        for k, v in state.items():
            np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
        model.load_state_dict(sd, strict=True)
        return
    if case == "stray_predictor_leaf":
        params["predictor"] = dict(params["predictor"], stray=stray)
    elif case == "stray_sequence_leaf":
        params["motion_mask"] = dict(params["motion_mask"], stray=stray)
    else:
        stats["pose_decoder"] = dict(stats["pose_decoder"], stray={"mean": np.zeros(4, np.float32)})
    with pytest.raises(KeyError, match="no place in the port"):
        state_dict_from_jax(params, stats)


def _blobby(seed, Q, K, h, w):
    """tests/test_fused_postprocess.py:21-38 fixture: blobby masks with
    generic thresholds so bf16 associativity cannot flip decisions."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.zeros((Q, h, w), np.float32)
    for q in range(Q):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        r = rng.uniform(2, 8)
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        masks[q] = (r - d) * rng.uniform(0.5, 2.0)
    cls = rng.randn(Q, K + 1).astype(np.float32) * 3
    return cls, masks


def _zero_logits():
    """tests/test_fused_postprocess.py:89-101: exact-zero logits are inside
    for panoptic (>= 0) and outside for instance (> 0)."""
    Q, K = 8, 3
    masks = np.zeros((Q, 16, 32), np.float32)
    masks[:, 6:10, 8:16] = 5.0
    masks[:, 0:2, :] = -4.0
    cls = np.full((Q, K + 1), -2.0, np.float32)
    cls[:, 1] = 3.0
    return cls, masks, np.array([False, True, False])


def assert_post_close(got, ref):
    """tests/test_fused_postprocess.py:59-86 tolerances: segment arrays,
    labels and query indices exact; per-pixel map mismatch < 3e-3 (bf16
    winner ties / threshold edges); scores atol/rtol 1e-3; boxes within 1."""
    got = {k: np.asarray(v) for k, v in got.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    for k in ("seg_id", "label", "isthing", "is_new_segment", "labels", "query_indices"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("sem_seg_argmax", "panoptic_seg"):
        assert got[k].dtype == np.uint8 and got[k].shape == ref[k].shape, k
        assert (got[k] != ref[k]).mean() < 3e-3, (k, (got[k] != ref[k]).mean())
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1.0)


@pytest.mark.parametrize("fixture", ["blobby0", "blobby1", "zero_logits", "blobby2_k40"])
def test_fused_plain_matches_jax_kernel_interpret(fixture):
    """The plain version of K1 (what a CPU tensor runs) against the JAX
    Pallas kernel in interpret mode. K = 40 is more classes than the CUDA
    kernel keeps in registers at once (it then loops over class chunks)."""
    from uni_encoder_tpu.inference.fused_postprocess import fused_multitask_inference as jfused
    from uni_encoder_tpu_torch.inference import fused_multitask_inference

    if fixture == "zero_logits":
        cls, masks, thing = _zero_logits()
    else:
        seed, _, k = fixture[len("blobby"):].partition("_k")
        Q, K = 20, int(k or 7)
        cls, masks = _blobby(int(seed), Q, K, 16, 32)
        thing = np.zeros(K, bool)
        thing[K // 2 :] = True
    Q = cls.shape[0]
    ref = jfused(jnp.asarray(cls), jnp.asarray(masks, jnp.bfloat16), jnp.asarray(thing),
                 object_mask_threshold=0.3, overlap_threshold=0.5, topk=Q, interpret=True)
    got = fused_multitask_inference(t(cls), t(masks).to(torch.bfloat16), t(thing),
                                    object_mask_threshold=0.3, overlap_threshold=0.5, topk=Q)
    assert_post_close(got, jax.tree_util.tree_map(np.asarray, ref))
    if fixture == "zero_logits":
        box = got["boxes"][0].numpy()
        assert box[2] - box[0] < 64, box  # hugs the positive blob, not the zero region


def test_uint8_guard():
    from uni_encoder_tpu_torch.inference import fused_multitask_inference

    with pytest.raises(ValueError):
        fused_multitask_inference(torch.zeros(256, 8), torch.zeros(256, 4, 4), torch.zeros(7, dtype=torch.bool))




def test_whole_slice_matches_jax(slice_pair):
    """forward_segmentation + fused post-process, fp32, 224x448.

    * pred_logits / pred_masks at SEG_ATOL 5e-3 / rtol 1e-3;
    * the post-process against the JAX kernel (interpret mode) on the JAX
      model's outputs, once fed the same outputs and once the port's own,
      at the K1 tolerances.
    The fixture keeps some queries and gives a non-empty panoptic map."""
    from uni_encoder_tpu.inference import segments_info_from_arrays as jsegments
    from uni_encoder_tpu.inference.fused_postprocess import fused_multitask_inference as jfused
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task
    from uni_encoder_tpu_torch.inference import fused_multitask_inference, segments_info_from_arrays

    model, jmodel, variables, _ = slice_pair
    rng = np.random.RandomState(1)
    img = rng.randn(1, common.H_IN, common.W_IN, 3).astype(np.float32)
    tokens = np.asarray([tokenize_task("The task is panoptic")], np.int32)

    jout = jax.jit(jmodel.apply)(variables, jnp.asarray(img), jnp.asarray(tokens))
    with torch.inference_mode():  # as a serving caller holds it
        pout = model.forward_segmentation(t(img), t(tokens))
    assert tuple(pout["pred_masks"].shape) == (1, common.NQ, common.H_IN // 4, common.W_IN // 4)
    np.testing.assert_allclose(pout["pred_logits"].numpy(), np.asarray(jout["pred_logits"]),
                               atol=common.SEG_ATOL, rtol=1e-3)
    np.testing.assert_allclose(pout["pred_masks"].numpy(), np.asarray(jout["pred_masks"]),
                               atol=common.SEG_ATOL, rtol=1e-3)

    thing = np.isin(np.arange(common.K), np.arange(common.K // 2, common.K))
    kw = dict(object_mask_threshold=0.8, overlap_threshold=0.8, topk=common.NQ)
    ref = jfused(jout["pred_logits"][0], jout["pred_masks"][0], jnp.asarray(thing), interpret=True, **kw)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    assert ref["is_new_segment"].any() and (ref["panoptic_seg"] > 0).any()

    same_in = fused_multitask_inference(t(np.asarray(jout["pred_logits"][0])),
                                        t(np.asarray(jout["pred_masks"][0])), t(thing), **kw)
    assert_post_close(same_in, ref)
    own = fused_multitask_inference(pout["pred_logits"][0], pout["pred_masks"][0], t(thing), **kw)
    assert own["sem_seg_argmax"].shape == (common.H_IN, common.W_IN)
    assert own["is_new_segment"].any() and (own["panoptic_seg"] > 0).any()
    assert_post_close(own, ref)
    assert segments_info_from_arrays(own) == jsegments(ref)
