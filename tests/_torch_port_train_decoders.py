"""Training with the decoder pairs the JAX build_pixel_decoder selects besides
the shipped one, against the JAX package on the CPU in fp32: the tests of
tests/test_torch_port_train_{dcmnet,fpn,msdeform}.py, one file a model (each
defines the fixture `letter`):

  (a) BasePixelDecoder + DCMNet (disparities at strides 2 to 16),
  (b) TransformerEncoderPixelDecoder + DepthTransformerEncoderPixelDecoder,
  (c) MSDeformAttnPixelDecoder + DepthMSDeformAttnPixelDecoder (4 to 32).

The scaled profile (tests/_torch_port_common.py) with the decoders and the
query decoder 64 wide (the depth heads' GroupNorm32 needs half of
`convs_dim` to be 32; at 32 the JAX model fails there), stochastic depth
off. One random d2 state dict (`random_d2_state`) drives both packages:
the JAX variables are filled from it through engine/convert.py's tables on
the tree `jax.eval_shape` of the JAX init gives (no JAX init is compiled).

Per model two jitted JAX functions, each a loss with its gradients with
respect to one decoder's parameters (the only path from those parameters
to the total loss): the segmentation forward in train mode and the JAX
criterion (pixel decoder), and forward_sequence_train and the JAX
monodepth loss (depth decoder, through the loss's gradient with respect
to the disparities). Their outputs hold the train-mode
forwards, the losses and the moved BatchNorm statistics. The draws come
from the JAX keys in the JAX code's split order (criterion.py:175,
monodepth.py:154-157), each monodepth scale at its disparity's size.

The JAX monodepth loss multiplies each scale's motion maps (stride 2^s)
with its disparity's maps, so it fails where the two differ (every model
here); the port's loss resizes the motion maps to the disparity's size
first (training/monodepth.py). The JAX loss is given the maps resized
with the JAX package's own `interpolate`, so the two losses compute the
same function.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_port_common as common
from _torch_port_common import t

MODELS = {"a": ("BasePixelDecoder", "DCMNet"),
          "b": ("TransformerEncoderPixelDecoder", "DepthTransformerEncoderPixelDecoder"),
          "c": ("MSDeformAttnPixelDecoder", "DepthMSDeformAttnPixelDecoder")}
DISP_STRIDES = {"a": (2, 4, 8, 16), "b": (4, 8, 16, 32), "c": (4, 8, 16, 32)}
WIDTH = 64  # convs_dim, mask_dim and the query decoder's hidden_dim
DEPTHS = (1, 1, 1, 1)  # Swin blocks a stage: the scaled profile's widths, half its depth
SEG_HW = (128, 256)
SEQ_HW = (96, 128)  # stride 32 leaves 3 rows: one ground row at the coarsest scale
B_SEG, B_SEQ, N_TARGETS = 1, 2, 4
STEP = 5000  # the ramped monodepth terms at 3 * 5000 / 35000 of their weight
TEXT_KEYS = ("text_encoder.", "text_projector.", "prompt_ctx.", "logit_scale")
MOTION_KEYS = ("complete_flow", "motion_mask", "motion_prob")
# the parameters whose gradients are held, per decoder
WATCHED = {
    "BasePixelDecoder": ("layer_4.weight", "adapter_1.weight", "mask_features.weight"),
    "TransformerEncoderPixelDecoder": ("transformer.encoder.layers.0.linear1.weight", "input_proj.weight",
                                       "adapter_1.weight", "mask_features.weight"),
    "MSDeformAttnPixelDecoder": ("transformer.encoder.layers.0.self_attn.sampling_offsets.weight",
                                 "transformer.encoder.layers.1.self_attn.value_proj.weight", "adapter_1.weight"),
    "DCMNet": ("psp_0.conv.weight", "bottleneck.bn.weight", "lateral_0.conv.weight", "fpn_bottleneck_0.conv.weight",
               "last_layer_0.weight", "last_layer_3.bias"),
    "DepthTransformerEncoderPixelDecoder": ("transformer.encoder.layers.0.self_attn.in_proj_weight",
                                            "layer_1.weight", "low_disp_3.conv0.weight", "low_disp_0.out.weight"),
    "DepthMSDeformAttnPixelDecoder": ("transformer.encoder.layers.0.self_attn.sampling_offsets.weight",
                                      "transformer.encoder.layers.0.self_attn.attention_weights.weight",
                                      "transformer.encoder.layers.1.self_attn.value_proj.weight",
                                      "input_proj.0.0.weight", "low_disp_3.conv0.weight"),
}
# fp32 gradients through a whole decoder and its loss, summed in other
# orders by XLA and by torch: relative norm error
GRAD_RTOL = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def train_cfg(C, letter):
    """The scaled profile with model `letter`'s decoders, is_train,
    stochastic depth off, from either package's config module `C`."""
    pixel, depth = MODELS[letter]
    cfg = common.make_cfg(C)
    sw = dataclasses.replace(cfg.backbone.swin, depths=DEPTHS, drop_path_rate=0.0)
    return dataclasses.replace(
        cfg, is_train=True, backbone=dataclasses.replace(cfg.backbone, swin=sw),
        one_former=dataclasses.replace(cfg.one_former, hidden_dim=WIDTH),
        sem_seg_head=dataclasses.replace(cfg.sem_seg_head, pixel_decoder_name=pixel, depth_decoder_name=depth,
                                         convs_dim=WIDTH, mask_dim=WIDTH))


def jax_variables_from_port(jax_shapes, state):
    """The JAX variables of the port's d2 state dict `state` (numpy), laid
    out as engine/convert.py's tables place each key in `jax_shapes` (the
    tree of jax.eval_shape of the JAX init)."""
    from uni_encoder_tpu_torch.engine.convert import _tables_for

    to_jax = {"ident": lambda v: v, "linear": lambda v: v.T, "conv": lambda v: v.transpose(2, 3, 1, 0)}
    trees = {col: {} for col in jax_shapes}
    flat = {col: {tuple(p.key for p in path): np.broadcast_to(np.float32(0), leaf.shape)  # shapes only
                  for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
            for col, tree in jax_shapes.items()}
    used = set()
    for src, col, dst, kind in _tables_for(flat["params"]).records:
        if dst in flat.get(col, {}):
            value = np.ascontiguousarray(to_jax[kind](state[src]))
            assert value.shape == tuple(flat[col][dst].shape), (src, value.shape)
            node = trees[col]
            for part in dst[:-1]:
                node = node.setdefault(part, {})
            node[dst[-1]] = jnp.asarray(value)
            used.add(src)
    assert sum(len(f) for f in flat.values()) == len(used)
    return trees, used


def jax_motion_at_disp_sizes(outputs):
    """The JAX outputs with each scale's motion maps resized (the JAX
    package's bilinear `interpolate`) to that scale's disparity size."""
    from uni_encoder_tpu.ops import interpolate

    def at(x, s):
        hw = outputs["disps"][s].shape[1:3]
        return x if x.shape[1:3] == hw else interpolate(x, size=hw, mode="bilinear", align_corners=False)

    return dict(outputs, **{k: {(f, s): at(v, s) for (f, s), v in outputs[k].items()} for k in MOTION_KEYS})


def port_draws(trainer, r_seg, r_seq, B, N, seq_hw):
    """The port's criterion and monodepth draws from the JAX keys, in the
    JAX code's split order; each monodepth scale at the size
    `Trainer.disparity_sizes` gives (held against the forward by
    test_make_draws_at_the_disparity_sizes)."""
    from uni_encoder_tpu_torch.training.monodepth import ground_rows

    crit = trainer.criterion
    draws = {"drop_seg": None, "drop_seq": None, "criterion": [], "monodepth": {}}
    key = r_seg
    for _ in range(trainer.n_prediction_sets()):
        key, r_match, r_pts = jax.random.split(key, 3)
        r1, r2 = jax.random.split(r_pts)
        draws["criterion"].append({
            "match": t(np.asarray(jax.random.uniform(r_match, (B, crit.num_points, 2)))),
            "oversampled": t(np.asarray(jax.random.uniform(r1, (B * N, crit.n_sampled, 2)))),
            "uniform": t(np.asarray(jax.random.uniform(r2, (B * N, crit.num_points - crit.n_uncertain, 2))))})
    H, W = seq_hw
    md = {"noise": [], "ransac_idx": [], "n_ground": []}
    key = r_seq
    for h, w in trainer.disparity_sizes(H, W):
        key, rn, rg = jax.random.split(key, 3)
        n = ground_rows(h) * w
        md["noise"].append(t(np.asarray(jax.random.normal(rn, (B_SEQ, H, W, 2)))))
        md["ransac_idx"].append(torch.from_numpy(np.asarray(jax.random.randint(rg, (B_SEQ, 100, 5), 0, n))
                                                 .astype(np.int64)))
        md["n_ground"].append(n)
    draws["monodepth"] = md
    return draws


def inputs():
    """The step's numpy inputs from seeds: a segmentation batch with
    N_TARGETS targets, text features and a task prompt; three frames with
    their intrinsics."""
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task

    rng = np.random.RandomState(41)
    H, W = SEG_HW
    seg = {"images": rng.randn(B_SEG, H, W, 3).astype(np.float32),
           "task_tokens": np.asarray([tokenize_task("The task is panoptic")] * B_SEG, np.int64),
           "labels": rng.randint(0, common.K, (B_SEG, N_TARGETS)).astype(np.int64),
           "masks": rng.rand(B_SEG, N_TARGETS, H // 4, W // 4) > 0.5,
           "valid": np.asarray([[True] * (N_TARGETS - 1) + [False]] * B_SEG),
           "text_feats": rng.randn(B_SEG, common.NQ, WIDTH).astype(np.float32),
           "logit_scale": np.float32(np.log(1 / 0.07))}
    h, w = SEQ_HW
    K = np.broadcast_to(np.eye(4, dtype=np.float32), (B_SEQ, 4, 4)).copy()
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 0.58 * w, 1.92 * h, 0.5 * w, 0.5 * h
    seq = {k: (rng.randn(B_SEQ, h, w, 3) * 0.5).astype(np.float32) for k in ("images", "prev_images", "next_images")}
    seq["K"], seq["inv_K"] = K, np.linalg.inv(K).astype(np.float32)
    return seg, seq


def seq_targets(seq, to):
    return {"color": {0: to(seq["images"]), -1: to(seq["prev_images"]), 1: to(seq["next_images"])},
            "K": to(seq["K"]), "inv_K": to(seq["inv_K"])}


def seg_targets(seg, to):
    return {k: to(seg[k]) for k in ("labels", "masks", "valid", "text_feats", "logit_scale")}


def run_once(fn, *args):
    """`fn(*args)` compiled by XLA's CPU backend at optimization level 0: the
    same program, compiled in about two thirds of the time (it runs once)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


@pytest.fixture(scope="module")
def run(letter):
    return build_run(letter)


def build_run(letter):
    """Both packages on model `letter`: the port's training model (weights
    from one random d2 state dict, text modules as drawn), its Trainer, the
    numpy inputs, the draws, and the JAX side's losses, outputs, moved
    statistics and gradients (d2 names)."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as J
    from uni_encoder_tpu.training.monodepth import monodepth_loss as jmonodepth
    from uni_encoder_tpu.training.train_step import Trainer as JTrainer
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder
    from uni_encoder_tpu_torch.training.train_step import Trainer

    torch.set_num_threads(1)
    model = UniEncoder(train_cfg(TC, letter), device="cpu")
    state = common.random_d2_state(model, seed=43)
    model.load_state_dict({k: t(v) for k, v in state.items()}, strict=True)
    seg, seq = inputs()

    jt = JTrainer(dataclasses.replace(JC.Config(), model=train_cfg(JC, letter)))
    jmodel = jt.model

    def both(m, img, tok, cur, prev, nxt):
        return m.forward_segmentation(img, tok), m.forward_sequence_train(cur, prev, nxt)

    shapes = jax.eval_shape(lambda k, *xs: jmodel.init(k, *xs, method=both), jax.random.PRNGKey(0),
                            jnp.asarray(seg["images"]), jnp.asarray(seg["task_tokens"], jnp.int32),
                            *(jnp.asarray(seq[k]) for k in ("images", "prev_images", "next_images")))
    variables, used = jax_variables_from_port(dict(shapes), state)
    assert sorted(set(state) - used) == sorted(k for k in state if k.startswith(TEXT_KEYS))
    r_seg, r_seq = jax.random.PRNGKey(1), jax.random.PRNGKey(2)

    def seg_loss(dec, stats):
        v = {"params": dict(variables["params"], pixel_decoder=dec), "batch_stats": stats}
        out, _ = jmodel.apply(v, jnp.asarray(seg["images"]), jnp.asarray(seg["task_tokens"], jnp.int32),
                              mutable=["batch_stats"])
        losses = jt.criterion(r_seg, out, seg_targets(seg, jnp.asarray))
        return losses["loss_total"], (out, losses)

    def seq_loss(dec, stats):
        """The sequence side: its outputs, statistics and losses, the loss's
        gradient with respect to the disparities, and through the depth
        decoder's VJP with respect to its parameters."""
        def forward(dec):
            v = {"params": dict(variables["params"], depth_decoder=dec), "batch_stats": stats}
            frames = (jnp.asarray(seq[k]) for k in ("images", "prev_images", "next_images"))
            out, mut = jmodel.apply(v, *frames, method=J.forward_sequence_train, mutable=["batch_stats"])
            return out["disps"], (out, mut["batch_stats"])

        def loss(disps, out):
            losses = jmonodepth(r_seq, jax_motion_at_disp_sizes(dict(out, disps=disps)), seq_targets(seq, jnp.asarray),
                                jnp.asarray(STEP))
            return losses["loss_monodepth"], losses

        disps, vjp, (out, moved) = jax.vjp(forward, dec, has_aux=True)
        (_, losses), g_disps = jax.value_and_grad(loss, has_aux=True)(disps, out)
        return out, moved, losses, g_disps, vjp(g_disps)[0]

    stats = variables["batch_stats"]
    (_, (seg_out, seg_losses)), g_pix = run_once(jax.value_and_grad(seg_loss, has_aux=True),
                                                 variables["params"]["pixel_decoder"], stats)
    seq_out, moved, seq_losses, g_disps, g_depth = run_once(seq_loss, variables["params"]["depth_decoder"], stats)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables["params"])
    grads = state_dict_from_jax(dict(zeros, pixel_decoder=g_pix, depth_decoder=g_depth))
    trainer = Trainer(dataclasses.replace(TC.Config(), model=train_cfg(TC, letter)), device="cpu")
    return {"model": model, "trainer": trainer, "seg": seg, "seq": seq,
            "draws": port_draws(trainer, r_seg, r_seq, B_SEG, N_TARGETS, SEQ_HW),
            "jax": {"seg_out": seg_out, "seg_losses": seg_losses, "seq_out": seq_out, "seq_losses": seq_losses,
                    "disp_grads": {s: t(np.asarray(g)) for s, g in g_disps.items()},
                    "stats": state_dict_from_jax(variables["params"], {**stats, **moved}), "grads": grads},
            "shapes": shapes, "letter": letter}


@contextlib.contextmanager
def statistics_kept(model):
    """Yields the model's BatchNorm statistics before the block and puts them
    back after it (the module fixture's statistics stay as drawn)."""
    before = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    try:
        yield before
    finally:
        model.load_state_dict(before, strict=False)


def port_sequence(run):
    """The port's forward_sequence_train on the run's frames, in train mode."""
    run["model"].train()
    return run["model"].forward_sequence_train(*(t(run["seq"][k]) for k in ("images", "prev_images", "next_images")))


# ----------------------------------------------------------------- forwards
def test_forward_segmentation_train_matches_jax(run):
    """The final predictions, the earlier prediction sets and the seeded
    queries' contrastive logits at SEG_ATOL 5e-3 / rtol 1e-3 (the
    tolerances of tests/test_torch_port_train.py)."""
    model, seg, ref = run["model"], run["seg"], run["jax"]["seg_out"]
    model.train()
    got = model.forward_segmentation(t(seg["images"]), t(seg["task_tokens"]))
    assert got["pred_logits"].grad_fn is not None
    assert len(got["aux_outputs"]) == len(ref["aux_outputs"]) == common.DEC_LAYERS - 1
    tol = dict(atol=common.SEG_ATOL, rtol=1e-3)
    for g, r in [(got, ref)] + list(zip(got["aux_outputs"], ref["aux_outputs"])):
        for k in ("pred_logits", "pred_masks"):
            np.testing.assert_allclose(_np(g[k]), np.asarray(r[k]), err_msg=f"({run['letter']}) {k}", **tol)
    np.testing.assert_allclose(_np(got["contrastive_logits"]), np.asarray(ref["contrastive_logits"]), **tol)


def test_forward_sequence_train_matches_jax(run):
    """The three-frame training forward: every disparity scale at its
    decoder's stride, poses, flows and motion maps at SEQ_ATOL 1e-5 / rtol
    1e-4; the BatchNorm statistics it moves against the JAX copy's, atol
    1e-5, rtol 1e-4; DCMNet's stay as stored (FrozenBatchNorm with its
    statistics in training, as the JAX DCMNet builds it)."""
    ref = run["jax"]["seq_out"]
    with statistics_kept(run["model"]) as before:
        got = port_sequence(run)
        after = {k: v.clone() for k, v in run["model"].state_dict().items() if "running_" in k}
    h, w = SEQ_HW
    assert [tuple(got["disps"][s].shape) for s in range(4)] == [(B_SEQ, h // st, w // st, 1)
                                                               for st in DISP_STRIDES[run["letter"]]]
    tol = dict(atol=common.SEQ_ATOL, rtol=1e-4)
    for key in ("disps", "cam_T_cam") + MOTION_KEYS:
        assert sorted(got[key], key=str) == sorted(ref[key], key=str), key
        for k in ref[key]:
            np.testing.assert_allclose(_np(got[key][k]), np.asarray(ref[key][k]), err_msg=f"{key} {k}", **tol)
    stats = {k: v for k, v in run["jax"]["stats"].items() if "running_" in k}
    assert sorted(stats) == sorted(after)
    frozen = [k for k in stats if k.startswith("sem_seg_head.depth_decoder.")]
    assert bool(frozen) == (run["letter"] == "a")
    for k, v in stats.items():
        assert torch.equal(after[k], before[k]) == (k in frozen), k
        np.testing.assert_allclose(after[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-4, err_msg=k)


# -------------------------------------------------------------------- losses
def test_monodepth_loss_terms_match_jax(run):
    """The port's monodepth loss on the JAX forward's own outputs (the motion
    maps at their strides: the port resizes them) against the JAX loss on
    the same outputs with the maps resized, with the same draws: every term
    at rtol 1e-4, atol 1e-5, the total at 5e-4 (the tolerances of
    tests/test_torch_port_train.py's whole step), d_ground at 1e-2: on
    random weights the RANSAC's best inlier counts nearly tie, and one
    ulp of a distance can pick another plane (at scale 1 of (a), 24x32,
    JAX's plane gives a d_ground 1.1e-3 from the port's, 3.7e-3 of the
    sum over scales, with XLA at optimization level 0; under 2e-3 at its
    default level);
    a ground term at the wrong rows, size or divisor moves it by tens of
    percent."""
    from uni_encoder_tpu_torch.training import monodepth

    ref = run["jax"]["seq_out"]
    outputs = {k: ({kk: t(np.asarray(v)) for kk, v in ref[k].items()}) for k in ref}
    got = monodepth.monodepth_loss(outputs, seq_targets(run["seq"], t), STEP, run["draws"]["monodepth"])
    want = run["jax"]["seq_losses"]
    assert sorted(got) == sorted(want)
    rtol = {"monodepth/d_ground": 1e-2, "loss_monodepth": 5e-4}
    for k, v in want.items():
        np.testing.assert_allclose(_np(got[k]), np.asarray(v), rtol=rtol.get(k, 1e-4), atol=1e-5,
                                   err_msg=f"({run['letter']}) {k}")


def test_criterion_matches_jax(run):
    """The segmentation losses of the port's train-mode forward against the
    JAX criterion's on the JAX forward, the same draws: every term at rtol
    1e-4, atol 1e-5 (tests/test_torch_port_train.py's whole step)."""
    model, seg = run["model"], run["seg"]
    model.train()
    out = model.forward_segmentation(t(seg["images"]), t(seg["task_tokens"]))
    got = run["trainer"].criterion(out, seg_targets(seg, t), run["draws"]["criterion"])
    want = run["jax"]["seg_losses"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(_np(got[k]), np.asarray(v), rtol=1e-4, atol=1e-5, err_msg=k)


def test_total_loss_gradients_match_jax(run):
    """The total loss's gradients (the criterion's plus the monodepth
    loss's) with respect to the watched parameters of both decoders, against
    jax.grad, each within GRAD_RTOL (1e-3) in relative norm (fp32 sums in
    other orders; tests/test_torch_port_train.py's whole-step bound).

    The pixel decoder's through the port's own forward and criterion. The
    depth decoder's as the chain rule composes them: the depth decoder's
    backward (the port's autograd through its forward_sequence_train) given
    the JAX monodepth loss's gradient with respect to the disparities. On
    random weights the loss's own gradient is ill-conditioned in fp32: the
    photometric warp puts points near the camera plane, where its gradient
    grows as 1 / z^2, and the RANSAC plane and the minimum over the
    reprojections choose discretely (the same outputs through both
    packages' losses give disparity gradients 3e-4 to 2e-2 apart, and
    frames moved by one ulp move the port's by up to 4e-3), so the loss's
    values are held term by term (test_monodepth_loss_terms_match_jax) and
    its gradient as the JAX package computes it. On (c) the deformable
    attention's plain gradient path runs on both sides (K3's reference on
    the card)."""
    model, seg = run["model"], run["seg"]
    pixel, depth = MODELS[run["letter"]]
    names = [f"sem_seg_head.pixel_decoder.{n}" for n in WATCHED[pixel]] + \
            [f"sem_seg_head.depth_decoder.{n}" for n in WATCHED[depth]]
    named = dict(model.named_parameters())
    model.train()
    model.zero_grad(set_to_none=True)
    with statistics_kept(model):
        seg_out = model.forward_segmentation(t(seg["images"]), t(seg["task_tokens"]))
        seg_loss = run["trainer"].criterion(seg_out, seg_targets(seg, t), run["draws"]["criterion"])["loss_total"]
        disps = port_sequence(run)["disps"]
        torch.autograd.backward([seg_loss] + [disps[s] for s in sorted(disps)],
                                [torch.ones(())] + [run["jax"]["disp_grads"][s] for s in sorted(disps)])
    errs = {}
    for n in names:
        g, r = named[n].grad, run["jax"]["grads"][n]
        assert g is not None and r.norm() > 0, n
        errs[n] = ((g - r).norm() / r.norm()).item()
    model.zero_grad(set_to_none=True)
    assert max(errs.values()) < GRAD_RTOL, errs


# --------------------------------------------------------------------- draws
def test_make_draws_at_the_disparity_sizes(run):
    """`Trainer.make_draws` draws each monodepth scale for the size of the
    disparity the built depth decoder emits there (the noise at the frame's
    size, the RANSAC indices into that scale's ground rows), and
    `shard_draws` over 2 ranks gives each rank its rows of the global
    draws: the ranks' rows together are the global draws."""
    from uni_encoder_tpu_torch.training.monodepth import ground_rows

    model, trainer = run["model"], run["trainer"]
    h, w = SEQ_HW
    with torch.no_grad(), statistics_kept(model):
        out = port_sequence(run)
    sizes = [tuple(out["disps"][s].shape[1:3]) for s in range(4)]
    assert trainer.disparity_sizes(h, w) == sizes
    seg = {"images": torch.zeros(B_SEG, *SEG_HW, 3), "labels": torch.zeros(B_SEG, N_TARGETS, dtype=torch.int64)}
    seq = {"images": torch.zeros(B_SEQ, h, w, 3)}
    world = 2
    draws = trainer.make_draws(torch.Generator().manual_seed(9), seg, seq, torch.device("cpu"), world=world)
    md = draws["monodepth"]
    assert md["n_ground"] == [ground_rows(a) * b for a, b in sizes]
    for s, n in enumerate(md["n_ground"]):
        assert tuple(md["noise"][s].shape) == (world * B_SEQ, h, w, 2)
        assert tuple(md["ransac_idx"][s].shape) == (world * B_SEQ, 100, 5)
        assert 0 <= int(md["ransac_idx"][s].min()) and int(md["ransac_idx"][s].max()) < n
    shards = [trainer.shard_draws(draws, r, world) for r in range(world)]
    for key in ("noise", "ransac_idx"):
        for s in range(4):
            assert torch.equal(torch.cat([sh["monodepth"][key][s] for sh in shards]), md[key][s])
    assert all(sh["monodepth"]["n_ground"] == md["n_ground"] for sh in shards)
    for i, d in enumerate(draws["criterion"]):
        for k, v in d.items():
            assert torch.equal(torch.cat([sh["criterion"][i][k] for sh in shards]), v), k


# ------------------------------------------------------------------ buckets
def test_optimizer_buckets_match_jax(run):
    """Every parameter of the training model but the text encoder (held by
    tests/test_torch_port_train_parts.py) lands in the bucket the JAX
    trainer's _bucket_index gives its flax path, names mapped by
    engine/convert.py's table."""
    from uni_encoder_tpu.training.train_step import _bucket_index
    from uni_encoder_tpu_torch.engine.convert import param_paths
    from uni_encoder_tpu_torch.training.train_step import bucket_index

    params = run["shapes"]["params"]
    paths = param_paths(params)
    named = {k: p for k, p in run["model"].named_parameters() if not k.startswith(TEXT_KEYS)}
    assert sorted(paths) == sorted(named)
    chosen = {}
    for k, p in named.items():
        leaf = params
        for part in paths[k][1]:
            leaf = leaf[part]
        got = bucket_index(k, p)
        assert got == _bucket_index(("[0]",) + paths[k][1], np.zeros(leaf.shape, np.float32)), k
        if k.startswith(("sem_seg_head.pixel_decoder.", "sem_seg_head.depth_decoder.")):
            chosen.setdefault(got, 0)
            chosen[got] += 1
    assert sorted(chosen) == [0, 1]  # the decoders: no decay for vectors, decay for kernels
