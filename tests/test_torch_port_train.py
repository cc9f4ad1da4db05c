"""The port's training path against the JAX package, on the CPU in fp32: the
deformable-sampling gradients, the train-mode forwards, and whole training
steps; and that serving holds no autograd state.

Inputs and weights are made with numpy from seeds; random draws with
jax.random in the JAX code's own split order, handed to both sides.
Tolerances are stated per test.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_port_common as common
from _torch_port_common import t

TEXT_KEYS = ("text_encoder.", "text_projector.", "prompt_ctx.", "logit_scale")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _no_drop_path(cfg):
    """`cfg` with is_train and stochastic depth off (its masks come from
    jax.random inside flax modules, which the port cannot reproduce)."""
    sw = dataclasses.replace(cfg.backbone.swin, drop_path_rate=0.0)
    return dataclasses.replace(cfg, is_train=True, backbone=dataclasses.replace(cfg.backbone, swin=sw))


# ------------------------------------------------------------ MSDA gradients
MSDA_SHAPES = ((5, 7), (3, 4), (2, 2))


def _msda_case(seed, B=2, M=4, D=4, Lq=9, P=4):
    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in MSDA_SHAPES)
    L = len(MSDA_SHAPES)
    value = rng.randn(B, S, M, D).astype(np.float32)
    cot = rng.randn(B, Lq, M * D).astype(np.float32)
    return rng, value, cot, (B, M, D, Lq, L, P)


@pytest.mark.parametrize("seed", [0, 1])
def test_msda_core_gradients_match_jax(seed):
    """Autograd of the plain sampling core against jax.grad of the JAX
    ms_deform_attn (normalized locations; the port's absolute ones are
    loc * (W, H) - 0.5), with tests/test_ms_deform_attn.py:92-95's
    tolerances: value and weights atol 2e-5, rtol 1e-4; locations atol
    5e-4, rtol 1e-4. Locations stay off exact grid lines."""
    from uni_encoder_tpu.ops import ms_deform_attn
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_plain

    rng, value, cot, (B, M, D, Lq, L, P) = _msda_case(seed + 10)
    loc = (rng.uniform(-0.15, 1.15, size=(B, Lq, M, L, P, 2)) + 0.00137).astype(np.float32)
    attn = rng.rand(B, Lq, M, L, P).astype(np.float32)
    attn = attn / attn.reshape(B, Lq, M, -1).sum(-1)[..., None, None]

    def f(v, l, a):
        return jnp.sum(ms_deform_attn(v, MSDA_SHAPES, l, a) * jnp.asarray(cot))

    gv, gl, ga = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))

    tv, tl, ta = (t(x).requires_grad_(True) for x in (value, loc, attn))
    wh = torch.tensor([[w, h] for h, w in MSDA_SHAPES], dtype=torch.float32)[:, None, :]  # (L, 1, 2)
    ms_deform_attn_plain(tv, MSDA_SHAPES, tl * wh - 0.5, ta).backward(t(cot))
    np.testing.assert_allclose(_np(tv.grad), np.asarray(gv), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(ta.grad), np.asarray(ga), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(tl.grad), np.asarray(gl), atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_msda_fused_gradients_match_jax(seed):
    """Autograd of the plain fused op (the backward kernel's reference)
    against jax.grad of the JAX module's producer math (softmax over each
    head's L * P logits, ref_abs + offset, the cm_abs sampling core), for
    value, offsets and logits; tolerances as above (offsets as locations)."""
    from uni_encoder_tpu.ops import ms_deform_attn
    from uni_encoder_tpu_torch.models.pixel_decoders.msdeformattn import absolute_reference_points
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_fused_plain

    rng, value, cot, (B, M, D, Lq, L, P) = _msda_case(seed + 20)
    off = (rng.uniform(-2.5, 2.5, size=(B, Lq, M * L * P * 2)) + 0.00137).astype(np.float32)
    logits = (rng.randn(B, Lq, M * L * P) * 2).astype(np.float32)
    ref_abs = absolute_reference_points(MSDA_SHAPES, torch.device("cpu"))[:, :Lq].contiguous()
    ref_cm = jnp.asarray(ref_abs.numpy()).transpose(0, 2, 1)  # (L, 2, Lq)

    def f(v, o, z):
        o_cm = jnp.transpose(o, (0, 2, 1)).reshape(B, M, L, P, 2, Lq)
        w_cm = jax.nn.softmax(jnp.transpose(z, (0, 2, 1)).reshape(B, M, L * P, Lq), axis=2).reshape(B, M, L, P, Lq)
        loc = ref_cm[None, None, :, None] + o_cm
        return jnp.sum(ms_deform_attn(v, MSDA_SHAPES, loc, w_cm, layout="cm_abs") * jnp.asarray(cot))

    gv, go, gz = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(value), jnp.asarray(off), jnp.asarray(logits))
    tv, to, tz = (t(x).requires_grad_(True) for x in (value, off, logits))
    ms_deform_attn_fused_plain(tv, MSDA_SHAPES, to, tz, ref_abs).backward(t(cot))
    np.testing.assert_allclose(_np(tv.grad), np.asarray(gv), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(tz.grad), np.asarray(gz), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(to.grad), np.asarray(go), atol=5e-4, rtol=1e-4)


# ------------------------------------------------------- train-mode forwards
@pytest.fixture(scope="module")
def train_pair():
    """The scaled profile built for training (stochastic depth off) in both
    packages, on one random d2 state dict; the JAX variables leave out the
    text encoder, which the JAX model does not hold."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as JUniEncoder
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    torch.set_num_threads(1)
    model = UniEncoder(_no_drop_path(common.make_cfg(TC)), device="cpu")
    state = common.random_d2_state(model, seed=13)
    model.load_state_dict({k: t(v) for k, v in state.items()}, strict=True)
    variables = common.jax_variables({k: v for k, v in state.items() if not k.startswith(TEXT_KEYS)})
    return model, JUniEncoder(_no_drop_path(common.make_cfg(JC))), variables


def test_forward_segmentation_train_matches_jax(train_pair):
    """is_train: the final predictions, the DEC_LAYERS - 1 earlier sets
    (after the seed and each round but the last) and the seeded queries,
    at the scaled profile's segmentation tolerance (atol 5e-3, rtol 1e-3)."""
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task

    model, jmodel, variables = train_pair
    img = np.random.RandomState(21).randn(1, common.H_IN, common.W_IN, 3).astype(np.float32)
    tokens = np.asarray([tokenize_task("The task is semantic")], np.int64)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img), jnp.asarray(tokens, jnp.int32))
    got = model.forward_segmentation(t(img), t(tokens))
    assert got["pred_logits"].grad_fn is not None  # the forward records autograd
    assert len(got["aux_outputs"]) == len(ref["aux_outputs"]) == common.DEC_LAYERS - 1
    tol = dict(atol=common.SEG_ATOL, rtol=1e-3)
    pairs = [(got, ref)] + list(zip(got["aux_outputs"], ref["aux_outputs"]))
    for g, r in pairs:
        for k in ("pred_logits", "pred_masks"):
            np.testing.assert_allclose(_np(g[k]), np.asarray(r[k]), err_msg=k, **tol)
    np.testing.assert_allclose(_np(got["contrastive_logits"]), np.asarray(ref["contrastive_logits"]), **tol)


def test_forward_sequence_train_matches_jax(train_pair):
    """The three-frame training forward (batch 2, 64 x 128): disparities,
    poses, flows and motion masks at SEQ_ATOL 1e-5 / rtol 1e-4, and the
    BatchNorm statistics it moves (batch statistics of both neighbour pairs)
    against the JAX copy's updated batch_stats, atol 1e-5, rtol 1e-4."""
    from uni_encoder_tpu.models.oneformer import UniEncoder as J
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax

    model, jmodel, variables = train_pair
    rng = np.random.RandomState(22)
    frames = [rng.randn(2, 64, 128, 3).astype(np.float32) for _ in range(3)]
    ref, mut = jax.jit(lambda v, *f: jmodel.apply(v, *f, method=J.forward_sequence_train,
                                                   mutable=["batch_stats"]))(variables, *map(jnp.asarray, frames))
    before = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    try:
        got = model.forward_sequence_train(*map(t, frames))
        after = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    finally:
        model.load_state_dict(before, strict=False)  # the module fixture's statistics stay as drawn
    tol = dict(atol=common.SEQ_ATOL, rtol=1e-4)
    for key in ("disps", "cam_T_cam", "complete_flow", "motion_mask", "motion_prob"):
        assert sorted(got[key], key=str) == sorted(ref[key], key=str), key
        for k in ref[key]:
            np.testing.assert_allclose(_np(got[key][k]), np.asarray(ref[key][k]), err_msg=f"{key} {k}", **tol)
    stats = {k: v for k, v in state_dict_from_jax(variables["params"], mut["batch_stats"]).items() if "running_" in k}
    assert sorted(stats) == sorted(after)
    for k, v in stats.items():
        assert not torch.equal(after[k], before[k]), k
        np.testing.assert_allclose(after[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-4, err_msg=k)


# ------------------------------------------------------------- whole steps
def test_train_step_micro_two_steps():
    """The port's Trainer at the micro config on the CPU: two steps from one
    generator; every loss finite, the parameters moved, the BatchNorm
    statistics moved, step and optimizer count 2; the same seed and
    generator give the same step again (draws in a fixed order)."""
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.training.train_step import Trainer

    seg, seq = (common.tree_map(t, b) for b in common.micro_batches())
    runs = []
    for _ in range(2):
        trainer = Trainer(common.micro_config(TC), device="cpu")
        state = trainer.init(seed=0)
        p0 = {k: v.detach().clone() for k, v in state.model.named_parameters()}
        s0 = {k: v.clone() for k, v in state.model.named_buffers() if "running_" in k}
        gen = torch.Generator().manual_seed(5)
        metrics = [trainer.train_step(state, seg, seq, gen)[1] for _ in range(2)]
        runs.append(metrics)
        for m in metrics:
            assert all(bool(torch.isfinite(v).all()) for v in m.values()), m
        moved = [not torch.equal(v, p0[k]) for k, v in state.model.named_parameters()]
        assert sum(moved) > 0.9 * len(moved)
        assert s0 and all(not torch.equal(v, s0[k]) for k, v in state.model.named_buffers() if k in s0)
        assert state.step == 2 and state.opt.count == 2
    for a, b in zip(*runs):
        assert all(torch.equal(a[k], b[k]) for k in a)


def _jax_draws(rng, trainer, seg, seq):
    """The port's draws for one step from the JAX train_step's key: its split
    order (train_step.py:287,304; criterion.py:175; monodepth.py:154-157).
    Stochastic depth is off, so the keep masks are None."""
    from uni_encoder_tpu_torch.training.monodepth import ground_rows

    _, _, r_losses = jax.random.split(rng, 3)
    r_seg, r_seq = jax.random.split(r_losses)
    crit = trainer.criterion
    B, N = seg["labels"].shape
    draws = {"drop_seg": None, "drop_seq": None, "criterion": [], "monodepth": {}}
    key = r_seg
    for _ in range(trainer.n_prediction_sets()):
        key, r_match, r_pts = jax.random.split(key, 3)
        r1, r2 = jax.random.split(r_pts)
        draws["criterion"].append({
            "match": t(np.asarray(jax.random.uniform(r_match, (B, crit.num_points, 2)))),
            "oversampled": t(np.asarray(jax.random.uniform(r1, (B * N, crit.n_sampled, 2)))),
            "uniform": t(np.asarray(jax.random.uniform(r2, (B * N, crit.num_points - crit.n_uncertain, 2))))})
    Bs, H, W = seq["images"].shape[:3]
    md = {"noise": [], "ransac_idx": [], "n_ground": []}
    key = r_seq
    for s in range(trainer.model_cfg.num_depth_scales):
        key, rn, rg = jax.random.split(key, 3)
        n = ground_rows(H >> s) * (W >> s)
        md["noise"].append(t(np.asarray(jax.random.normal(rn, (Bs, H, W, 2)))))
        md["ransac_idx"].append(torch.from_numpy(np.asarray(jax.random.randint(rg, (Bs, 100, 5), 0, n)).astype(np.int64)))
        md["n_ground"].append(n)
    draws["monodepth"] = md
    return draws


GRAD_NAMES = (
    "sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn.sampling_offsets.weight",
    "sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn.value_proj.weight",
    "backbone.layers.0.blocks.0.attn.qkv.weight",
    "sem_seg_head.predictor.class_embed.weight",
    "motion_decoder.conv5.0.weight",
    "pose_decoder.convs.pose_2.weight",
    "sem_seg_head.depth_decoder.layers.output_conv.0.weight",
    "text_encoder.transformer.resblocks.0.attn.in_proj_weight",
    "logit_scale",
)


@pytest.mark.slow
def test_train_step_matches_jax():
    """One whole training step at the micro config, the JAX trainer's loss
    function (jitted once) against the port's, from the same weights (JAX's
    init carried across by engine/convert.py, loaded strictly) and the same
    draws: every loss term at rtol 1e-4 (atol 1e-5; d_ground and the totals
    as the monodepth test states), and the gradients of GRAD_NAMES at a
    relative norm error below 1e-3 (fp32 gradients through the whole model,
    summed in other orders by XLA and by torch; the median over all
    parameters is 4e-5). Parameters right behind a normalization (a conv
    bias before BatchNorm or GroupNorm, exactly 0 in exact arithmetic) and
    the pose decoder's BatchNorms, which normalize 4 to 64 values per
    channel at this size, are not compared: there both sides hold rounding
    noise. Marked slow: jitting the
    JAX step takes over 90 s on one CPU core (tests/test_train_step.py:63)."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as J
    from uni_encoder_tpu.training.monodepth import monodepth_loss as jmonodepth
    from uni_encoder_tpu.training.train_step import Trainer as JTrainer
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.engine.convert import param_paths, state_dict_from_jax
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder
    from uni_encoder_tpu_torch.training.train_step import Trainer

    seg_np, seq_np = common.micro_batches()
    seg_j = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in seg_np.items()}
    seq_j = {k: jnp.asarray(v) for k, v in seq_np.items()}
    jt = JTrainer(common.micro_config(JC))
    jstate = jax.jit(jt.init)(jax.random.PRNGKey(0), seg_j, seq_j)
    rng = jax.random.PRNGKey(1)

    def loss_fn(trainable, batch_stats):  # the JAX train_step's loss function, all terms returned
        params, text_params = trainable
        variables = {"params": params, "batch_stats": batch_stats}
        _, _, r_losses = jax.random.split(rng, 3)
        seg_out, _ = jt.model.apply(variables, seg_j["images"], seg_j["task_tokens"], mutable=["batch_stats"])
        text = jt.text_encoder.apply({"params": text_params}, seg_j["text_tokens"])
        r_seg, r_seq = jax.random.split(r_losses)
        seg_l = jt.criterion(r_seg, seg_out, {"labels": seg_j["labels"], "masks": seg_j["masks"],
                                              "valid": seg_j["valid"], "text_feats": text["texts"],
                                              "logit_scale": text["logit_scale"]})
        seq_out, _ = jt.model.apply(variables, seq_j["images"], seq_j["prev_images"], seq_j["next_images"],
                                    method=J.forward_sequence_train, mutable=["batch_stats"])
        seq_l = jmonodepth(r_seq, seq_out, {"color": {0: seq_j["images"], -1: seq_j["prev_images"],
                                                      1: seq_j["next_images"]},
                                            "K": seq_j["K"], "inv_K": seq_j["inv_K"]}, jnp.asarray(0))
        out = {**seg_l, **seq_l, "loss": seg_l["loss_total"] + seq_l["loss_monodepth"]}
        return out["loss"], out

    (_, ref), (gp, gt) = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        (jstate.params, jstate.text_params), jstate.batch_stats)

    model = UniEncoder(common.micro_config(TC).model, device="cpu", task_seq_len=16)
    model.load_state_dict(state_dict_from_jax(jstate.params, jstate.batch_stats, jstate.text_params), strict=True)
    trainer = Trainer(common.micro_config(TC), device="cpu")
    state = trainer.init(model=model)
    seg, seq = (common.tree_map(t, b) for b in (seg_np, seq_np))
    got = trainer.losses(state, seg, seq, _jax_draws(rng, trainer, seg, seq))
    got["loss"].backward()
    rtol = {"monodepth/d_ground": 2e-3, "loss_monodepth": 5e-4, "loss": 5e-4}
    for k, v in ref.items():
        np.testing.assert_allclose(_np(got[k]), np.asarray(v), rtol=rtol.get(k, 1e-4), atol=1e-5, err_msg=k)
    paths = param_paths(jstate.params, jstate.text_params)
    named = dict(model.named_parameters())
    errs = {}
    for name in GRAD_NAMES:
        col, path, kind = paths[name]
        g = gp if col == "params" else gt
        for k in path:
            g = g[k]
        g = np.asarray(g)
        g = g.T if kind == "linear" else g.transpose(3, 2, 0, 1) if kind == "conv" else g
        errs[name] = np.linalg.norm(_np(named[name].grad) - g) / max(np.linalg.norm(g), 1e-12)
    assert max(errs.values()) < 1e-3, errs


# ------------------------------------------------------------------ serving
def test_serving_holds_no_autograd_state():
    """The forwards record autograd state when grad mode is on, so serving
    callers hold inference_mode: Predictor's entry points run the model
    under it, chip_smoke.py's served requests return inference tensors with
    no grad_fn, and a training step may follow a served request in the same
    process (the device constants cached by the first request are normal
    tensors)."""
    import chip_smoke  # the repository root is on the path (tests/conftest.py)
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task
    from uni_encoder_tpu_torch.engine.predictor import Predictor
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    model = common.port_model()
    seen = []
    model.backbone.register_forward_pre_hook(
        lambda *_: seen.append((torch.is_inference_mode_enabled(), torch.is_grad_enabled())))
    cfg = dataclasses.replace(TC.Config(), model=common.make_cfg(TC))
    pred = Predictor(cfg, model)
    pred.set_thing_ids(range(common.K // 2, common.K))
    rng = np.random.RandomState(3)
    tokens = np.asarray(tokenize_task(chip_smoke.TASK), np.int64)
    pred.infer_segmentation({"image": rng.randint(0, 256, (64, 96, 3), np.uint8), "task_tokens": tokens})
    pred.infer_sequence({"image": rng.randint(0, 256, (64, 96, 3), np.uint8),
                         "prev_image": rng.randint(0, 256, (64, 96, 3), np.uint8)})
    assert seen == [(True, False), (True, False)]

    images = t(rng.randn(1, 64, 96, 3).astype(np.float32))
    thing = torch.arange(common.K) >= common.K // 2
    out, post = chip_smoke.serve_segmentation(model, images, t(tokens[None]), thing)
    seq = chip_smoke.serve_sequence(model, images, images)
    leaves = [v for v in out.values()] + [v for p in post for v in p.values()] + \
             [v for v in seq.values() if torch.is_tensor(v)]
    assert leaves and all(x.is_inference() and x.grad_fn is None and not x.requires_grad for x in leaves)

    train = UniEncoder(_no_drop_path(common.make_cfg(TC)), device="cpu")
    train.load_state_dict(model.state_dict(), strict=False)
    loss = train.forward_segmentation(images, t(tokens[None]))["pred_masks"].square().mean()
    loss = loss + train.forward_sequence_train(images, images, images)["disps"][0].mean()
    loss.backward()
    assert train.backbone.layers[0].blocks[1].attn.relative_position_bias_table.grad is not None
