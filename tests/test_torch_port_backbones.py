"""The port's ResNet, ConvNeXt and DiNAT backbones and its neighborhood
attention against the JAX package, on the CPU: the plain version of K4
against the JAX op (the duplicate-index edge included), each backbone's
features (weights carried across with `state_dict_from_jax`), the state-dict
key set each config file gives against the JAX converter's records, and the
refusal to train on these backbones. The whole models are in
tests/test_torch_port_backbone_models.py.

Tolerances: fp32 atol/rtol 1e-4 for the backbones' features (sums of up to
a few thousand products in another order), 1e-5 for neighborhood attention
alone.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_port_common as common
from _torch_port_common import t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"resnet": "configs/cityscapes_r18.yaml", "convnext": "configs/cityscapes_convnext.yaml",
           "dinat": "configs/cityscapes_dinat.yaml"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ neighborhood attention
def _na_inputs(seed, B, H, W, nh, dh, kernel):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, W, nh, dh).astype(np.float32) for _ in range(3))
    rpb = rng.randn(nh, 2 * kernel - 1, 2 * kernel - 1).astype(np.float32)
    return q, k, v, rpb


@pytest.mark.parametrize("size,kernel", [(7, 3), (9, 3), (24, 7), (48, 7), (5, 3), (17, 5)])
@pytest.mark.parametrize("dilation", [1, 2, 3, 5, 20])
def test_axis_indices_match_jax(size, kernel, dilation):
    from uni_encoder_tpu.ops.neighborhood_attention import _axis_indices as jidx
    from uni_encoder_tpu_torch.ops.neighborhood_attention import _axis_indices

    for got, ref in zip(_axis_indices(size, kernel, dilation), jidx(size, kernel, dilation)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("H,W,dilation,kernel", [
    (7, 9, 1, 3), (7, 9, 2, 3), (12, 10, 3, 3),
    (5, 11, 3, 3),   # sub-grids of 2 rows under a kernel of 3: a repeated key
    (12, 20, 3, 7),  # sub-grids of 4 rows and 6-7 columns under a kernel of 7
    (14, 16, 2, 7),
])
def test_neighborhood_attention_plain_matches_jax(H, W, dilation, kernel):
    """fp32, a pre-scaled q as the JAX op takes it, and q scaled by the op
    (the module's path) against the JAX op on q * scale."""
    from uni_encoder_tpu.ops.neighborhood_attention import neighborhood_attention_2d as jna
    from uni_encoder_tpu_torch.ops.neighborhood_attention import _axis_indices, neighborhood_attention_2d

    q, k, v, rpb = _na_inputs(H * W + dilation, 2, H, W, 3, 4, kernel)
    ref = np.asarray(jna(*map(jnp.asarray, (q, k, v, rpb)), kernel, dilation))
    got = neighborhood_attention_2d(t(q), t(k), t(v), t(rpb), kernel, dilation)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    scale = 4 ** -0.5
    ref = np.asarray(jna(jnp.asarray(q) * scale, *map(jnp.asarray, (k, v, rpb)), kernel, dilation))
    got = neighborhood_attention_2d(t(q), t(k), t(v), t(rpb), kernel, dilation, scale=scale)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    if (H, dilation, kernel) == (5, 3, 3):  # the shape holds the duplicate-index edge
        idx = _axis_indices(H, kernel, dilation)[0]
        assert any(len(set(row)) < kernel for row in idx)


def test_neighborhood_attention_plain_reads_strided_qkv_views():
    """q, k, v as the module hands them: views of one (B, H, W, 3, heads,
    dh) tensor, equal to the same values made contiguous."""
    from uni_encoder_tpu_torch.ops.neighborhood_attention import neighborhood_attention_2d_plain

    rng = np.random.RandomState(3)
    qkv = t(rng.randn(1, 6, 10, 3, 2, 8).astype(np.float32))
    rpb = t(rng.randn(2, 5, 5).astype(np.float32))
    views = [qkv[:, :, :, i] for i in range(3)]
    assert not views[0].is_contiguous()
    got = neighborhood_attention_2d_plain(*views, rpb, 3, 2, scale=0.3)
    ref = neighborhood_attention_2d_plain(*(x.contiguous() for x in views), rpb, 3, 2, scale=0.3)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_neighborhood_attention_bf16_rounds_once():
    """bf16 inputs: the plain version computes in fp32 and rounds the
    output once, so it equals the fp32 result on the same (bf16) values
    rounded to bf16."""
    from uni_encoder_tpu_torch.ops.neighborhood_attention import neighborhood_attention_2d_plain

    q, k, v, rpb = (t(x).to(torch.bfloat16) for x in _na_inputs(5, 1, 8, 12, 2, 8, 3))
    got = neighborhood_attention_2d_plain(q, k, v, rpb, 3, 2)
    ref = neighborhood_attention_2d_plain(q.float(), k.float(), v.float(), rpb.float(), 3, 2)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref.to(torch.bfloat16), atol=0, rtol=0)


def test_neighborhood_attention_kernel_refuses_grad_and_cpu_tensors():
    """K4 has no backward: with grad mode on and an input that requires
    grad its wrapper raises before anything else; off the card it refuses
    CPU tensors instead of falling back."""
    from uni_encoder_tpu_torch.ops.neighborhood_attention import neighborhood_attention_2d_cuda

    q, k, v, rpb = (t(x) for x in _na_inputs(0, 1, 4, 4, 1, 8, 3))
    with pytest.raises(RuntimeError, match="no backward"):
        neighborhood_attention_2d_cuda(q.requires_grad_(True), k, v, rpb, 3)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        neighborhood_attention_2d_cuda(q, k, v, rpb, 3)


# ------------------------------------------------------------------ backbones
def _port_backbone(name):
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.models.oneformer import build_backbone

    cfg = dataclasses.replace(TC.Config().model, backbone=common.backbone_cfg(TC, name))
    return build_backbone(cfg).eval()


def _jax_backbone(name):
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import build_backbone

    return build_backbone(dataclasses.replace(JC.Config().model, backbone=common.backbone_cfg(JC, name)))


@pytest.mark.parametrize("name", ["resnet", "convnext", "dinat"])
def test_backbone_matches_jax(name):
    """A random d2 state dict (numpy, seeded) -> the JAX converter -> flax
    params and batch_stats -> `state_dict_from_jax` gives the state back
    exactly and loads strictly into the port; then both backbones on one
    (2, 64, 96, 3) input, every output at atol/rtol 1e-4."""
    from uni_encoder_tpu.engine import checkpoint as ckpt
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax

    model = _port_backbone(name)
    state = {f"backbone.{k}": v for k, v in common.random_d2_state(model, seed=5).items()}
    c = ckpt.Converter(state)
    common.convert_backbone(c, name)
    assert not c.unused, sorted(c.unused)[:8]
    sd = state_dict_from_jax(c.params, c.batch_stats)
    assert sorted(sd) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    model.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)

    x = np.random.RandomState(1).randn(2, 64, 96, 3).astype(np.float32)
    variables = {"params": c.params["backbone"]}
    if "backbone" in c.batch_stats:
        variables["batch_stats"] = c.batch_stats["backbone"]
    ref = jax.jit(_jax_backbone(name).apply)(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = model(t(x))
    assert sorted(got) == sorted(ref) == sorted(model.out_channels)
    for k, r in ref.items():
        assert got[k].shape[-1] == model.out_channels[k]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(r), atol=1e-4, rtol=1e-4, err_msg=k)


def test_resnet_bottleneck_matches_jax():
    """ResNet-50's BottleneckBlock (depth >= 50, not in a config) at half
    width: res2..res5 at atol/rtol 1e-4."""
    from uni_encoder_tpu.engine import checkpoint as ckpt
    from uni_encoder_tpu.models.backbones.resnet import ResNet as JResNet
    from uni_encoder_tpu_torch.models.backbones.resnet import ResNet

    model = ResNet(depth=50, stem_out_channels=16, res2_out_channels=32).eval()
    state = {f"backbone.{k}": v for k, v in common.random_d2_state(model, seed=6).items()}
    c = ckpt.Converter(state)
    ckpt.convert_resnet(c, (3, 4, 6, 3), bottleneck=True)
    assert not c.unused, sorted(c.unused)[:8]
    model.load_state_dict({k[len("backbone."):]: t(v) for k, v in state.items()}, strict=True)
    x = np.random.RandomState(2).randn(1, 64, 64, 3).astype(np.float32)
    jmodel = JResNet(depth=50, stem_out_channels=16, res2_out_channels=32)
    ref = jax.jit(jmodel.apply)({"params": c.params["backbone"], "batch_stats": c.batch_stats["backbone"]},
                                jnp.asarray(x))
    with torch.inference_mode():
        got = model(t(x))
    for k, r in ref.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(r), atol=1e-4, rtol=1e-4, err_msg=k)


# ------------------------------------------------------------ configs' key sets
def _broadcast_state(model):
    """Zero-byte numpy stand-ins of every state-dict entry (meta tensors
    hold no values), for the JAX converter's name and layout rules."""
    return {k: np.broadcast_to(np.float32(0), tuple(v.shape)) for k, v in model.state_dict().items()}


def _paths(variables):
    """(collection, *path) of every leaf of flax variables."""
    return {(col,) + tuple(p.key for p in path)
            for col, tree in variables.items() for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_tree_paths(cfg):
    """(collection, *path) of every parameter and statistic of the JAX
    UniEncoder for the port's config values, from shapes alone: the
    backbone's from its own init, the heads' from the segmentation and
    sequence inits of the same model on a small ResNet (the heads' names do
    not depend on the backbone's widths)."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as J, build_backbone

    name = cfg.model.backbone.name
    sub = getattr(JC, {"resnet": "ResNetConfig", "convnext": "ConvNeXtConfig", "dinat": "DiNATConfig"}[name])
    jb = JC.BackboneConfig(name=name, **{name: sub(**dataclasses.asdict(getattr(cfg.model.backbone, name)))})
    small = JC.BackboneConfig(name="resnet", resnet=JC.ResNetConfig(stem_out_channels=8, res2_out_channels=8))
    img, key = jnp.zeros((1, 64, 64, 3), jnp.float32), jax.random.PRNGKey(0)
    backbone = jax.eval_shape(build_backbone(dataclasses.replace(JC.Config().model, backbone=jb)).init, key, img)
    heads = J(dataclasses.replace(JC.Config().model, backbone=small))
    head_trees = (jax.eval_shape(heads.init, key, img, jnp.zeros((1, 77), jnp.int32)),
                  jax.eval_shape(lambda: heads.init(key, img, img, method=J.forward_sequence)))
    return ({(p[0], "backbone") + p[1:] for p in _paths(backbone)}
            | {p for tree in head_trees for p in _paths(tree) if p[1] != "backbone"})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_builds_the_d2_key_set(name):
    """`evaluate_torch.build_model` on the config file (read by the port's
    YAML reader), on the meta device, at full width and depth: its
    state-dict keys are exactly the sources of the JAX converters' records
    (the backbone's `convert_resnet` / `convert_convnext` / `convert_dinat`
    and the heads') whose flax leaf the JAX UniEncoder of the same config
    has. The records the JAX model has no leaf for are modules the JAX
    package does not build: the shortcuts of blocks that do not project,
    and the reference motion decoders' layer1..4."""
    import evaluate_torch
    from uni_encoder_tpu.engine import checkpoint as ckpt
    from uni_encoder_tpu_torch.config import load_config

    cfg = load_config(os.path.join(REPO, CONFIGS[name]))
    assert cfg.model.backbone.name == name
    model, _ = evaluate_torch.build_model(cfg, device="meta")
    keys = set(model.state_dict())
    m = cfg.model
    c = ckpt.Converter(_broadcast_state(model))
    b = getattr(m.backbone, name)
    if name == "resnet":
        ckpt.convert_resnet(c, {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}[b.depth])
    elif name == "convnext":
        ckpt.convert_convnext(c, b.depths)
    else:
        ckpt.convert_dinat(c, b.depths)
    ckpt.convert_msdeform_pixel_decoder(c, layers=m.sem_seg_head.transformer_enc_layers)
    ckpt.convert_query_decoder(c, dec_layers=m.one_former.dec_layers - 1,
                               class_dec_layers=m.one_former.class_dec_layers)
    ckpt.convert_task_mlp(c)
    ckpt.convert_transdssl(c)
    ckpt.convert_pose_decoder(c)
    ckpt.convert_motion_decoder(c, "motion_decoder")
    ckpt.convert_motion_decoder(c, "motion_mask")
    assert not c.unused, sorted(c.unused)[:8]
    jax_paths = _jax_tree_paths(cfg)
    expected = {src for src, col, dst, _ in c.records if (col,) + dst in jax_paths}
    assert keys == expected, (sorted(keys - expected)[:8], sorted(expected - keys)[:8])
    n_blocks = 8 if name == "resnet" else sum(b.depths)
    block_word = {"resnet": ".conv2.weight", "convnext": ".dwconv.weight", "dinat": ".attn.rpb"}[name]
    assert sum(k.startswith("backbone.") and k.endswith(block_word) for k in keys) == n_blocks


@pytest.mark.parametrize("name", ["resnet", "convnext", "dinat"])
def test_train_mode_on_a_new_backbone_raises(name):
    """A model built with is_train on each backbone builds (training is
    ported for all four) with the JAX copy's stochastic-depth rates, a
    linspace from 0 to the config's drop_path_rate over all blocks; its
    backbone raises on keep masks that do not fit its layout (ResNet takes
    none)."""
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    cfg = dataclasses.replace(common.make_cfg(TC, name), is_train=True)
    model = UniEncoder(cfg, device="meta")
    if name == "resnet":
        masks = torch.ones(4, 1)
    else:
        c = getattr(cfg.backbone, name)
        blocks = [m for m in model.backbone.modules() if hasattr(m, "drop_path_rate")]
        np.testing.assert_allclose([m.drop_path_rate for m in blocks], np.linspace(0.0, c.drop_path_rate,
                                                                                    sum(c.depths)))
        masks = torch.ones(sum(c.depths) + 1, 2, 1)
    with pytest.raises(ValueError, match="drop"):
        model.backbone(torch.zeros(1, 32, 32, 3), masks)


@pytest.mark.parametrize("name", ["convnext", "dinat"])
def test_drop_masks_are_refused(name):
    """Keep masks for another number of blocks than the backbone's are
    refused (a mask per block: `Trainer.make_draws` lays them out)."""
    model = _port_backbone(name)
    with pytest.raises(ValueError, match="drop-path"):
        model(torch.zeros(1, 32, 32, 3), torch.ones(8, 2, 1))
