"""Training on the ResNet, ConvNeXt and DiNAT backbones against the JAX
package, on the CPU in fp32 at the scaled profile (tests/_torch_port_common.py).

- The train-mode forwards with given keep masks: the JAX backbones draw
  their drop-path masks from flax's rng inside the module, so the test
  replaces `drop_path` in `uni_encoder_tpu.models.backbones.{convnext,dinat}`
  (for the duration of one trace) by one that consumes the port's masks in
  call order; blocks whose rate is 0 call no drop_path in the JAX copy and
  ignore their masks in the port. forward_segmentation at SEG_ATOL 5e-3 /
  rtol 1e-3, forward_sequence_train at SEQ_ATOL 1e-5 / rtol 1e-4 (the
  tolerances of tests/test_torch_port_train.py), with the BatchNorm
  statistics it moves.
- The backbone's gradients through one loss (a random projection of its
  features) against jax.grad, mapped to the port's names by
  engine/convert.py: each parameter's gradient within 1e-4 of its norm
  (fp32 sums in other orders).
- ResNet's BatchNorm statistics stay as stored through a training step,
  as the JAX ResNet's `batch_stats` do; the decoders' move.
- `Trainer.make_draws`' keep masks per backbone, the optimizer buckets
  against JAX's `_bucket_index`, and two iterations of `train_torch.main`
  on each of configs/cityscapes_{r18,convnext,dinat}.yaml, scaled by
  overrides, on `data/synthetic.py`'s training tree.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_port_common as common
from _torch_port_common import t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT_KEYS = ("text_encoder.", "text_projector.", "prompt_ctx.", "logit_scale")
BACKBONES = ["resnet", "convnext", "dinat"]
SEG_HW, SEQ_HW = (128, 256), (64, 128)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _train_cfg(C, backbone):
    return dataclasses.replace(common.make_cfg(C, backbone), is_train=True)


@pytest.fixture(scope="module", params=BACKBONES)
def train_pair(request):
    """The port's training model and the JAX one (is_train: stochastic depth
    on) on one random d2 state dict, the JAX variables (without the text
    encoder, which the JAX model does not hold), and the backbone's name."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as JUniEncoder
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    torch.set_num_threads(1)
    name = request.param
    model = UniEncoder(_train_cfg(TC, name), device="cpu")
    state = common.random_d2_state(model, seed=29)
    model.load_state_dict({k: t(v) for k, v in state.items()}, strict=True)
    variables = common.jax_variables({k: v for k, v in state.items() if not k.startswith(TEXT_KEYS)}, name)
    return model, JUniEncoder(_train_cfg(JC, name)), variables, name


def _n_blocks(cfg, name):
    return 0 if name == "resnet" else sum(getattr(cfg.backbone, name).depths)


def _keep_masks(seed, cfg, name, batch):
    """Port-layout keep masks (Trainer.make_draws'), about a third zero;
    None for ResNet."""
    n = _n_blocks(cfg, name)
    if not n:
        return None
    shape = (n, batch) if name == "convnext" else (n, 2, batch)
    return (np.random.RandomState(seed).rand(*shape) < 0.65).astype(np.float32)


def _jax_drop_path(monkeypatch, name, masks):
    """Make the JAX backbone consume `masks` (port layout) in call order.
    Returns the list of masks still to be consumed."""
    from uni_encoder_tpu.models.backbones import convnext as jconvnext
    from uni_encoder_tpu.models.backbones import dinat as jdinat

    left = [] if masks is None else list(masks[1:].reshape(-1, masks.shape[-1]))  # block 0's rate is 0

    def consume(x, rate, deterministic, rng=None):
        if deterministic or rate == 0.0:
            return x
        keep = jnp.asarray(left.pop(0), x.dtype).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return x / (1.0 - rate) * keep

    for mod in (jconvnext, jdinat):
        monkeypatch.setattr(mod, "drop_path", consume)
    return left


RNGS = {"drop_path": jax.random.PRNGKey(0)}  # consumed by make_rng only: the masks are given


# ----------------------------------------------------------------- forwards
def test_forward_segmentation_train_with_keep_masks_matches_jax(train_pair, monkeypatch):
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task

    model, jmodel, variables, name = train_pair
    rng = np.random.RandomState(31)
    img = rng.randn(2, *SEG_HW, 3).astype(np.float32)
    tokens = np.asarray([tokenize_task("The task is panoptic")] * 2, np.int64)
    masks = _keep_masks(3, model.cfg, name, 2)
    left = _jax_drop_path(monkeypatch, name, masks)
    ref = jax.jit(lambda v, x, k: jmodel.apply(v, x, k, rngs=RNGS))(variables, jnp.asarray(img),
                                                                    jnp.asarray(tokens, jnp.int32))
    assert not left  # every mask was consumed
    model.train()
    got = model.forward_segmentation(t(img), t(tokens), None if masks is None else t(masks))
    assert got["pred_logits"].grad_fn is not None
    tol = dict(atol=common.SEG_ATOL, rtol=1e-3)
    for g, r in [(got, ref)] + list(zip(got["aux_outputs"], ref["aux_outputs"])):
        for k in ("pred_logits", "pred_masks"):
            np.testing.assert_allclose(_np(g[k]), np.asarray(r[k]), err_msg=f"{name} {k}", **tol)
    np.testing.assert_allclose(_np(got["contrastive_logits"]), np.asarray(ref["contrastive_logits"]), **tol)


def test_forward_sequence_train_with_keep_masks_matches_jax(train_pair, monkeypatch):
    """The three-frame training forward (batch 2) and the BatchNorm
    statistics it moves against the JAX copy's updated batch_stats (atol
    1e-5, rtol 1e-4): on ResNet none of the backbone's moves, in either."""
    from uni_encoder_tpu.models.oneformer import UniEncoder as J
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax

    model, jmodel, variables, name = train_pair
    rng = np.random.RandomState(32)
    frames = [rng.randn(2, *SEQ_HW, 3).astype(np.float32) for _ in range(3)]
    masks = _keep_masks(4, model.cfg, name, 6)
    left = _jax_drop_path(monkeypatch, name, masks)
    ref, mut = jax.jit(lambda v, *f: jmodel.apply(v, *f, method=J.forward_sequence_train, mutable=["batch_stats"],
                                                   rngs=RNGS))(variables, *map(jnp.asarray, frames))
    assert not left
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    try:
        got = model.forward_sequence_train(*map(t, frames), None if masks is None else t(masks))
        after = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    finally:
        model.load_state_dict(before, strict=False)  # the module fixture's statistics stay as drawn
    tol = dict(atol=common.SEQ_ATOL, rtol=1e-4)
    for key in ("disps", "cam_T_cam", "complete_flow", "motion_mask", "motion_prob"):
        for k in ref[key]:
            np.testing.assert_allclose(_np(got[key][k]), np.asarray(ref[key][k]), err_msg=f"{name} {key} {k}", **tol)
    full = {**variables["batch_stats"], **mut["batch_stats"]}  # the JAX statistics after the forward
    stats = {k: v for k, v in state_dict_from_jax(variables["params"], full).items() if "running_" in k}
    assert sorted(stats) == sorted(after)
    for k, v in stats.items():
        moved = not torch.equal(after[k], before[k])
        assert moved == (not k.startswith("backbone.")), k  # decoders move; ResNet's backbone keeps its own
        np.testing.assert_allclose(after[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-4, err_msg=k)


def test_backbone_gradients_match_jax(train_pair, monkeypatch):
    """jax.grad of sum(features * cotangent) with respect to the backbone's
    parameters, keep masks given, against the port's autograd: each
    parameter's gradient within 1e-4 of the JAX gradient's norm."""
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax

    model, jmodel, variables, name = train_pair
    rng = np.random.RandomState(33)
    img = rng.randn(2, *SEQ_HW, 3).astype(np.float32)  # DiNAT's stage 0 at dilation 8: 2x4 sub-grids
    masks = _keep_masks(5, model.cfg, name, 2)
    model.train()
    model.zero_grad(set_to_none=True)
    feats = model.backbone(t(img), None if masks is None else t(masks))
    cot = {k: rng.randn(*v.shape).astype(np.float32) for k, v in sorted(feats.items())}
    sum((f * t(cot[k])).sum() for k, f in feats.items()).backward()

    left = _jax_drop_path(monkeypatch, name, masks)

    def loss(params):
        out = jmodel.apply({**variables, "params": params}, jnp.asarray(img), method=lambda m, x: m.backbone(x),
                           rngs=RNGS)
        return sum((out[k] * jnp.asarray(c)).sum() for k, c in cot.items())

    grads = jax.jit(jax.grad(loss))(variables["params"])
    assert not left
    ref = {k: v for k, v in state_dict_from_jax(grads).items() if k.startswith("backbone.")}
    named = {k: p for k, p in model.named_parameters() if k.startswith("backbone.")}
    assert sorted(ref) == sorted(named)
    for k, p in named.items():
        err = (p.grad - ref[k]).norm().item()
        assert err <= 1e-4 * ref[k].norm().item() + 1e-7, (name, k, err, ref[k].norm().item())


# ---------------------------------------------------- ResNet's statistics
def test_resnet_training_step_keeps_backbone_statistics():
    """One Trainer step on the scaled ResNet model: every backbone
    BatchNorm keeps its stored statistics (the JAX ResNet builds them with
    use_running_average=True), its weights and biases move, and the
    decoders' statistics move."""
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.training.train_step import Trainer

    micro = common.micro_config(TC)
    cfg = dataclasses.replace(micro, model=dataclasses.replace(micro.model, backbone=common.backbone_cfg(TC, "resnet")))
    seg, seq = (common.tree_map(t, b) for b in common.micro_batches())
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init(seed=0)
    stats0 = {k: v.clone() for k, v in state.model.named_buffers() if "running_" in k}
    norms0 = {k: v.detach().clone() for k, v in state.model.named_parameters() if k.startswith("backbone.")
              and ".norm." in k}
    _, metrics = trainer.train_step(state, seg, seq, torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    stats = dict(state.model.named_buffers())
    backbone = [k for k in stats0 if k.startswith("backbone.")]
    assert backbone and all(torch.equal(stats[k], stats0[k]) for k in backbone)
    assert all(not torch.equal(stats[k], v) for k, v in stats0.items() if not k.startswith("backbone."))
    params = dict(state.model.named_parameters())
    assert norms0 and all(not torch.equal(params[k], v) for k, v in norms0.items())


# -------------------------------------------------------------------- draws
@pytest.mark.parametrize("name", ["swin"] + BACKBONES)
def test_make_draws_keep_masks_per_backbone(name):
    """Swin and DiNAT: (blocks, 2, B); ConvNeXt: (blocks, B); ResNet: None;
    for the segmentation batch and the sequence pass's 3B frames; 0s and 1s,
    the same from the same seed."""
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.training.train_step import Trainer

    cfg = dataclasses.replace(TC.Config(), model=_train_cfg(TC, name))
    trainer = Trainer(cfg, device="cpu")
    seg = {"images": torch.zeros(2, 32, 64, 3), "labels": torch.zeros(2, 5, dtype=torch.int64)}
    seq = {"images": torch.zeros(3, 32, 64, 3)}
    draws = [trainer.make_draws(torch.Generator().manual_seed(7), seg, seq, torch.device("cpu")) for _ in range(2)]
    n = _n_blocks(cfg.model, name)
    for key, batch in (("drop_seg", 2), ("drop_seq", 9)):
        got = draws[0][key]
        if name == "resnet":
            assert got is None and draws[1][key] is None
            continue
        assert tuple(got.shape) == ((n, batch) if name == "convnext" else (n, 2, batch)), (name, key)
        assert set(got.unique().tolist()) <= {0.0, 1.0} and torch.equal(got, draws[1][key])


# ------------------------------------------------------------------ buckets
@pytest.mark.parametrize("name", BACKBONES)
def test_optimizer_buckets_match_jax(name):
    """Every parameter of the training model but the text encoder (held by
    tests/test_torch_port_train_parts.py) lands in the bucket the JAX
    trainer's _bucket_index gives its flax path, names mapped by
    engine/convert.py's table: DiNAT's 3-D rpb decays, ConvNeXt's 1-D gamma
    does not."""
    from uni_encoder_tpu.training.train_step import _bucket_index
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.engine.convert import param_paths
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder
    from uni_encoder_tpu_torch.training.train_step import bucket_index

    model = UniEncoder(_train_cfg(TC, name), device="meta")
    state = {k: v for k, v in common.random_d2_state(model).items() if not k.startswith(TEXT_KEYS)}
    params = common.jax_variables(state, name)["params"]
    paths = param_paths(params)
    named = {k: p for k, p in model.named_parameters() if not k.startswith(TEXT_KEYS)}
    assert sorted(paths) == sorted(named)
    for k, p in named.items():
        leaf = params
        for part in paths[k][1]:
            leaf = leaf[part]
        assert bucket_index(k, p) == _bucket_index(("[0]",) + paths[k][1], leaf), k
    special = {"dinat": ("attn.rpb", 3), "convnext": ("gamma", 2)}.get(name)
    if special:
        chosen = [bucket_index(k, p) for k, p in named.items() if k.endswith(special[0])]
        assert chosen and set(chosen) == {special[1]}  # backbone group: 3 decays, 2 does not


# --------------------------------------------------------- the entry point
# the shipped configs at the scaled profile's widths, crops of 64x128
SCALED = ["input.seg_crop_train=[64,128]", "input.seg_min_size_train=[64]", "input.seg_max_size_train=256",
          "input.depth_hw_train=[64,128]", "model.one_former.num_object_queries=8", "model.one_former.dec_layers=2",
          "model.one_former.class_dec_layers=1", "model.one_former.dim_feedforward=64",
          "model.one_former.hidden_dim=32", "model.one_former.nheads=4", "model.one_former.train_num_points=64",
          "model.sem_seg_head.transformer_enc_layers=1", "model.sem_seg_head.convs_dim=32",
          "model.sem_seg_head.mask_dim=32", "model.text_encoder.width=32", "model.text_encoder.num_layers=1",
          "model.text_encoder.proj_num_layers=1", "model.text_encoder.n_ctx=2", "model.num_depth_scales=2"]
SCALED_BACKBONE = {
    "r18": ["model.backbone.resnet.stem_out_channels=16", "model.backbone.resnet.res2_out_channels=16"],
    "convnext": ["model.backbone.convnext.depths=[1,1,2,1]", "model.backbone.convnext.dims=[32,64,128,256]"],
    # stage 1 at dilation 8 on an 8x16 map: sub-grids of 1 and 2 keys, repeated
    "dinat": ["model.backbone.dinat.embed_dim=32", "model.backbone.dinat.depths=[1,2,2,1]",
              "model.backbone.dinat.num_heads=[1,2,4,8]", "model.backbone.dinat.dilations=[[1],[1,8],[1,4],[1]]"],
}


@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    from uni_encoder_tpu_torch.data import synthetic

    root = str(tmp_path_factory.mktemp("synthetic_train"))
    synthetic.write_cityscapes_train(root, 2, (128, 256))
    return root


@pytest.mark.parametrize("config", ["r18", "convnext", "dinat"])
def test_train_entry_point_two_iterations(config, train_tree, tmp_path):
    """`train_torch.main` on configs/cityscapes_{config}.yaml, scaled by
    overrides: two iterations with finite losses in train.py's records, the
    backbone the config names, a checkpoint, and on ResNet-18 the backbone's
    BatchNorm statistics as initialised."""
    import train_torch
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    cfg_path = os.path.join(REPO, "configs", f"cityscapes_{config}.yaml")
    opts = SCALED + SCALED_BACKBONE[config]
    out = str(tmp_path / "run")
    state = train_torch.main(["--config", cfg_path, "--datasets-root", train_tree, "--output-dir", out, "--max-iter",
                              "2", "--batch", "2", "--log-period", "1", "--checkpoint-period", "2", "--device", "cpu",
                              *opts])
    with open(os.path.join(out, "metrics.json")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    assert [r["iteration"] for r in records] == [0, 1]
    assert all(np.isfinite(r[k]) for r in records for k in ("loss", "loss_seg", "loss_monodepth"))
    assert state.step == 2 and os.path.isfile(os.path.join(out, "step_2.pt"))
    cfg = load_config(cfg_path, opts)
    assert type(state.model.backbone).__name__.lower() == {"r18": "resnet"}.get(config, config)
    if config == "r18":
        fresh = UniEncoder(dataclasses.replace(cfg.model, is_train=True), device="cpu", seed=0,
                           task_seq_len=cfg.input.task_seq_len)
        init = dict(fresh.named_buffers())
        stats = {k: v for k, v in state.model.named_buffers() if k.startswith("backbone.") and "running_" in k}
        assert stats and all(torch.equal(v, init[k]) for k, v in stats.items())
