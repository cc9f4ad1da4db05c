"""The port's tensor parallelism (`uni_encoder_tpu_torch/parallel/tensor.py`
on `parallel/mesh.py`'s data x model grid) on the CPU: gloo ranks started
with the `spawn` context, one thread each, a time limit per run
(tests/_torch_port_dist_common.py). The JAX package shards its parameters
by `param_spec` over the `model` axis of `make_mesh(n, model_parallel=M)`
and GSPMD keeps the unsharded arithmetic; these tests hold the port to
that:

- the rule: on the default config the port's selection, mapped to the JAX
  paths by the converter's names, equals the JAX `param_spec` on every leaf
  of `jax.eval_shape(Trainer.init)` (72 parameters, 54,362,112 elements);
  likewise on the JAX dry run's `_tiny_config` at `min_dim` 256, and the
  dry run's one added `in_proj` is the same parameter in both;
- modules against JAX: a Swin block (qkv, fc1, fc2 split), a patch merging
  (its reduction by rows), a deformable encoder layer (linear1, linear2)
  and the text encoder (c_fc, c_proj, the vocabulary, one attention
  in_proj) on 2 ranks against `jax.vjp` with `params_shardings` on
  `make_mesh(2, model_parallel=2)` of the conftest's virtual devices:
  output, input gradients and every parameter's gradient gathered whole;
- the whole micro step on (1 x 2), (2 x 2) and (1 x 3) grids (short blocks
  on the last; the pose decoder's ReLU gates one process's) against the
  port's one process at the global batch, within
  tests/test_torch_port_parallel.py's bounds; replicated parameters the
  same bytes on every rank; a global norm that counts the replicated
  gradients M times, and a gradient mean over the whole world instead of
  the data group, are caught.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port_dist_common as dist_common
from test_torch_port_parallel import BN_RTOL, GRAD_RTOL, LOSS_RTOL, STEP_SIZE

RULE_PARAMS, RULE_ELEMENTS = 72, 54_362_112  # the JAX rule at min_dim 1024 on the default config
STEP_SEED = 5
# The step cases split the parameters the rule selects at min_dim 64 on the
# micro model (31: Swin's fc1 / fc2, qkv and attention projections, both
# kinds of patch merging, the deformable encoder's sampling offsets and FFN,
# every attention in_proj of the query decoder and the text encoder, the
# FFNs, the vocabulary), and hold the step to the CPU bounds or twice the
# one process's own ulp-moved spread (`tp_step_rank`).
STEP_MIN_DIM = 64
STEP_PARAMS = 31


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dryrun_tool():
    """tools/dryrun_multichip_torch.py as a module."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "dryrun_multichip_torch.py")
    spec = importlib.util.spec_from_file_location("dryrun_multichip_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _jax_paths(shapes):
    """port name -> (JAX path string, JAX leaf) of every trainable leaf."""
    from uni_encoder_tpu_torch.engine.convert import param_paths

    trees = {"params": shapes.params, "text_params": shapes.text_params}
    out = {}
    for name, (collection, path, _) in param_paths(shapes.params, shapes.text_params).items():
        leaf = trees[collection]
        for key in path:
            leaf = leaf[key]
        out[name] = ("/".join(path), leaf)
    return out


def _rule_against_jax(jax_cfg, port_cfg, min_dim):
    """The JAX rule on every leaf of the JAX trainer's state and the port's
    selection on the same model: {port name: (jax spec, port spec, JAX
    path, elements)}, and the JAX paths of the params tree in key order."""
    from uni_encoder_tpu.parallel.mesh import param_spec
    from uni_encoder_tpu.training.train_step import Trainer as JTrainer
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder
    from uni_encoder_tpu_torch.parallel import tensor

    B, H, W = 1, 64, 64
    n_texts = jax_cfg.model.one_former.num_object_queries - jax_cfg.model.text_encoder.n_ctx
    seg = {"images": jnp.zeros((B, H, W, 3)), "task_tokens": jnp.ones((B, 77), jnp.int32),
           "text_tokens": jnp.ones((B, n_texts, 77), jnp.int32), "labels": jnp.zeros((B, 4), jnp.int32),
           "masks": jnp.zeros((B, 4, H // 4, W // 4), bool), "valid": jnp.ones((B, 4), bool)}
    K = jnp.broadcast_to(jnp.eye(4), (B, 4, 4))
    seq = {"images": jnp.zeros((B, H, W, 3)), "prev_images": jnp.zeros((B, H, W, 3)),
           "next_images": jnp.zeros((B, H, W, 3)), "K": K, "inv_K": K}
    shapes = jax.eval_shape(JTrainer(jax_cfg).init, jax.random.PRNGKey(0), seg, seq)
    port = tensor.selection(UniEncoder(port_cfg.model, device="meta", task_seq_len=port_cfg.input.task_seq_len),
                            min_dim)
    out = {}
    for name, (path, leaf) in _jax_paths(shapes).items():
        out[name] = (tuple(param_spec(path, leaf, min_dim)), port.get(name, ()), path, int(np.prod(leaf.shape)))
    n_leaves = sum(len(jax.tree_util.tree_leaves(t)) for t in (shapes.params, shapes.text_params))
    assert len(out) == n_leaves, "every JAX leaf has a port name"
    assert set(port) <= set(out)
    in_projs = [p for p, _ in sorted((("/".join(str(getattr(k, "key", k)) for k in path), 0) for path, _ in
                                      jax.tree_util.tree_flatten_with_path(shapes.params)[0]))
                if p.endswith("in_proj")]
    return out, in_projs


def test_rule_selects_what_the_jax_rule_shards_on_the_default_config():
    """The production rule (min_dim 1024) on the default Swin-T + MSDeformAttn
    training model: every leaf of the JAX trainer's params and text_params
    gets the same spec from the port (a parameter the port leaves
    replicated is P()): 72 parameters, 54,362,112 of 209,994,047 elements;
    chip_smoke.py's tensor_parallel phase checks these counts."""
    import chip_smoke
    from uni_encoder_tpu.config import Config as JConfig
    from uni_encoder_tpu_torch.config import Config

    jcfg = JConfig()
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, is_train=True))
    cfg = Config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, is_train=True))
    specs, _ = _rule_against_jax(jcfg, cfg, 1024)
    differ = {n: v for n, v in specs.items() if v[0] != v[1]}
    assert not differ, differ
    sharded = {n: v for n, v in specs.items() if v[0]}
    assert (len(sharded), sum(v[3] for v in sharded.values())) == (RULE_PARAMS, RULE_ELEMENTS)
    assert sum(v[3] for v in specs.values()) == 209_994_047
    assert (chip_smoke.TP_RULE_PARAMS, chip_smoke.TP_RULE_ELEMENTS) == (RULE_PARAMS, RULE_ELEMENTS)
    # column: Swin stage 3 and 4's qkv and fc1, the encoder's, the query
    # decoder's and the text encoder's up-projections; row: the rest and the
    # vocabulary
    assert sum(v[0] == (None, "model") for v in sharded.values()) == 39
    assert specs["text_encoder.token_embedding.weight"][:2] == (("model", None),) * 2


def test_rule_on_the_dry_run_config_and_its_in_proj():
    """The JAX dry run's `_tiny_config` at min_dim 256 against the port's
    copy (tools/dryrun_multichip_torch.py): the same selection on every
    leaf, and the tool's one added in_proj is the first in_proj leaf of the
    JAX params tree in key order, the one the JAX dry run adds."""
    import __graft_entry__

    tool = dryrun_tool()

    specs, in_projs = _rule_against_jax(__graft_entry__._tiny_config(), tool.tiny_config(), tool.MIN_DIM)
    differ = {n: v for n, v in specs.items() if v[0] != v[1]}
    assert not differ, differ
    assert specs[tool.IN_PROJ][2] == in_projs[0] and specs[tool.IN_PROJ][0] == ()
    assert sum(bool(v[0]) for v in specs.values()) == 13


# ------------------------------------------------------ modules against JAX
MODULE_TOL = dict(atol=1e-5, rtol=1e-5)


def _subtree_converter(records, dst_prefix, src_prefix):
    """A function taking a JAX module's params (the subtree at `dst_prefix`
    of the converter's `records`) to (the port module's state dict, with
    the names under `src_prefix` stripped; port name -> JAX path)."""
    from uni_encoder_tpu_torch.engine import convert

    def to_port(params):
        flat = convert._flatten(params)
        state, paths = {}, {}
        for src, _, dst, kind in records:
            rel = dst[len(dst_prefix):]
            if dst[:len(dst_prefix)] == dst_prefix and rel in flat and src.startswith(src_prefix):
                state[src[len(src_prefix):]] = np.array(convert._INVERSE[kind](np.asarray(flat[rel])))
                paths[src[len(src_prefix):]] = "/".join(rel)
        assert len(state) == len(flat), sorted(set(flat) - {d[len(dst_prefix):] for _, _, d, _ in records})
        return state, paths

    return to_port


def _text_converter(params):
    from uni_encoder_tpu_torch.engine import convert

    state = {k: v.numpy() for k, v in convert.state_dict_from_jax({}, text_params=params).items()}
    return state, {k: "/".join(path) for k, (_, path, _) in convert.param_paths({}, params).items()}


def _module_cases():
    """(kind, args, apply, JAX params, converter, inputs, min_dim, extra,
    JAX paths added by columns) of each module, at narrow widths with
    min_dim lowered so that the rule splits the parameters the production
    rule splits at full width."""
    from uni_encoder_tpu.models.backbones.swin import PatchMerging as JPM, SwinBlock as JBlock
    from uni_encoder_tpu.models.pixel_decoders.msdeformattn import MSDeformAttnEncoderLayer as JEnc
    from uni_encoder_tpu.models.pixel_decoders.msdeformattn import _reference_points
    from uni_encoder_tpu.training.train_step import _TextEncoder
    from uni_encoder_tpu_torch.engine import convert

    rng = np.random.RandomState(3)
    cases = {}

    def records(fn, *args):
        t = convert._Table()
        fn(t, *args)
        return t.records

    # a shifted Swin block of dim 32: qkv (32, 96) and fc1 (32, 128) by columns, fc2 by rows
    x = rng.randn(1, 14, 14, 32).astype(np.float32)
    jm = JBlock(dim=32, num_heads=2, window=7, shift=3)
    cases["swin_block"] = ("swin_block", {"dim": 32, "heads": 2, "window": 7, "shift": 3}, jm.apply,
                           jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"],
                           _subtree_converter(records(convert._swin, [1]), ("backbone", "layers_0_blocks_0"),
                                              "backbone.layers.0.blocks.0."), [x], 64, (), ())
    # a patch merging of dim 32: its reduction (128, 64) by rows
    x = rng.randn(1, 8, 12, 32).astype(np.float32)
    jm = JPM(dim=32)
    cases["patch_merging"] = ("patch_merging", {"dim": 32}, jm.apply,
                              jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))["params"],
                              _subtree_converter(records(convert._swin, [1, 1]), ("backbone", "layers_0_downsample"),
                                                 "backbone.layers.0.downsample."), [x], 128, (), ())
    # a deformable encoder layer, d_model 32, d_ffn 128: linear1 by columns, linear2 by rows
    shapes = ((2, 3), (4, 6), (8, 12))
    n = sum(h * w for h, w in shapes)
    src, pos = (rng.randn(1, n, 32).astype(np.float32) for _ in range(2))
    jm = JEnc(d_model=32, d_ffn=128, n_levels=3, n_heads=2, n_points=4)
    ref = jnp.asarray(_reference_points(shapes))
    params = jax.jit(jm.init, static_argnums=4)(jax.random.PRNGKey(3), jnp.asarray(src), jnp.asarray(pos), ref,
                                                shapes)["params"]
    cases["encoder_layer"] = ("encoder_layer", {"dim": 32, "ffn": 128, "heads": 2, "shapes": shapes},
                              lambda v, a, b, jm=jm: jm.apply(v, a, b, ref, shapes), params,
                              _subtree_converter(records(convert._msdeform_trunk, "", ("trunk",), 1, 0),
                                                 ("trunk", "encoder_layer_0"), "transformer.encoder.layers.0."),
                              [src, pos], 128, (), ())
    # the text encoder, width 32, vocabulary 512: c_fc by columns, c_proj and the vocabulary by rows, and
    # the attention's in_proj added by columns (as the JAX dry run adds one)
    L, vocab = 12, 512
    tokens = rng.randint(1, vocab, size=(2, 3, L)).astype(np.int64)
    tokens[..., 7] = vocab - 1
    jm = _TextEncoder(context_length=L, width=32, layers=1, vocab_size=vocab, hidden_dim=32, proj_num_layers=2,
                      n_ctx=2)
    cases["text"] = ("text", {"context": L, "width": 32, "layers": 1, "vocab": vocab, "hidden": 32, "n_ctx": 2},
                     lambda v, tok, jm=jm: jm.apply(v, tok)["texts"],
                     jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(tokens, jnp.int32))["params"],
                     _text_converter, [tokens], 128, ("text_encoder.transformer.resblocks.0.attn.in_proj_weight",),
                     ("text_encoder/resblock_0/attn/in_proj",))
    return cases


def _jax_vjp(apply, params, inputs, cotangent, min_dim, added):
    """apply's output, its vjp (parameters, float inputs) under jit with the
    parameters placed by `params_shardings` on make_mesh(2,
    model_parallel=2) (the `added` paths by columns), and each parameter's
    PartitionSpec by path."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from uni_encoder_tpu.parallel.mesh import make_mesh, params_shardings

    mesh = make_mesh(2, model_parallel=2)
    shardings = jax.tree_util.tree_map_with_path(
        lambda path, s: NamedSharding(mesh, P(None, "model")) if _path(path) in added else s,
        params_shardings(mesh, params, min_dim))
    xs = [jnp.asarray(x, jnp.int32 if x.dtype.kind == "i" else x.dtype) for x in inputs]
    floats = [i for i, x in enumerate(inputs) if x.dtype.kind == "f"]

    @jax.jit
    def run(p, ct):
        def f(p, *fx):
            args = list(xs)
            for i, v in zip(floats, fx):
                args[i] = v
            return apply({"params": p}, *args)

        out, vjp = jax.vjp(f, p, *[xs[i] for i in floats])
        return out, vjp(ct)

    with mesh:
        out, grads = run(jax.tree_util.tree_map(jax.device_put, params, shardings), jnp.asarray(cotangent))
    specs = {_path(path): tuple(s.spec) for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]}
    return out, grads[0], list(grads[1:]), specs


def _path(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)


def test_sharded_modules_on_two_ranks_match_jax_params_shardings(tmp_path):
    """Each module (`_module_cases`) on a (1 x 2) grid of gloo ranks, its
    weights carried from the JAX module's by the converter's names, against
    `jax.vjp` under jit with its parameters placed by the JAX
    `params_shardings` over the model axis of `make_mesh(2,
    model_parallel=2)`: the port splits exactly the parameters JAX does, by
    the same axis (each rank holds half of the whole); on both ranks the
    output, the gradients with respect to the inputs and every parameter's
    gradient (gathered whole) agree at atol / rtol 1e-5."""
    cases = _module_cases()
    rng = np.random.RandomState(5)
    jax_side, rank_cases = {}, {}
    for name, (kind, args, apply, params, to_port, inputs, min_dim, extra, added) in cases.items():
        shape = jax.eval_shape(lambda p: apply({"params": p}, *[
            jnp.asarray(x, jnp.int32 if x.dtype.kind == "i" else x.dtype) for x in inputs]), params).shape
        cot = rng.randn(*shape).astype(np.float32)
        jax_side[name] = _jax_vjp(apply, params, inputs, cot, min_dim, added)
        rank_cases[name] = (kind, args, to_port(params)[0], inputs, cot, min_dim, extra)
    ranks = dist_common.run_ranks(dist_common.tp_modules_rank, 2, tmp_path, rank_cases)
    for name, (kind, args, apply, params, to_port, inputs, min_dim, extra, added) in cases.items():
        out, dparams, dx, specs = jax_side[name]
        state, paths = to_port(params)
        ref_grads = to_port(dparams)[0]
        for r in ranks:
            got = r[name]
            assert {paths[k]: v for k, v in got["specs"].items()} == {p: s for p, s in specs.items() if s}, name
            for k, shape in got["blocks"].items():
                assert 2 * np.prod(shape) == state[k].size and sum(
                    a != b for a, b in zip(shape, state[k].shape)) == 1, (name, k, shape)
            np.testing.assert_allclose(_np(got["out"]), np.asarray(out), err_msg=f"{name} output", **MODULE_TOL)
            assert len(got["dx"]) == len(dx)
            for i, (g, ref) in enumerate(zip(got["dx"], dx)):
                np.testing.assert_allclose(_np(g), np.asarray(ref), err_msg=f"{name} input {i}", **MODULE_TOL)
            assert sorted(got["grads"]) == sorted(ref_grads)
            for k, ref in ref_grads.items():
                g = got["grads"][k]
                np.testing.assert_allclose(np.zeros_like(ref) if g is None else _np(g), ref, err_msg=f"{name} {k}",
                                           **MODULE_TOL)


# ------------------------------------------------------------ whole steps
@pytest.mark.parametrize("world,model_parallel", [(2, 2), (4, 2), (3, 3)], ids=["1x2", "2x2", "1x3"])
def test_grid_step_equals_one_process_at_the_global_batch(tmp_path, world, model_parallel):
    """The micro Trainer (deterministic, fp32, one thread, seed 0 weights)
    on a (world / M) x M grid, its parameters split at STEP_MIN_DIM
    (STEP_PARAMS parameters; on 1 x 3 the blocks of 64-, 128-, 256- and
    512-wide dimensions are short: 22 + 22 + 20, ...), the global batch of
    2 a modality at STEP_SIZE split over the data axis; one step against
    one process's step at the batch 2 from the same weights with the same
    draws, the ranks at its pose decoder's ReLU gates
    (`_torch_port_dist_common.tp_step_rank`, `pinned_choices`: on 2 x 2 one
    pre-activation of the second data index's rows is -1.3e-6 in one
    process and +3.9e-7 on the grid, and its gate alone moved the pose
    decoder's gradients by 2.5e-4), its sharded parameters, gradients and
    AdamW moments gathered whole, held to
    tests/test_torch_port_parallel.py's bounds (`chip_smoke.md_within_bounds`:
    losses, grad_norm and clip_scale within LOSS_RTOL, gradients and moments
    GRAD_RTOL, BatchNorm statistics BN_RTOL, each parameter element within
    its learning rate times its clipped gradient's relative difference; each
    of the first four also within twice its difference in one process's
    same step from images moved by one ulp).
    Every rank's replicated parameters, gradients, moments and buffers are
    the same bytes; the ranks of a data group hold the same bytes of their
    blocks; `tensor.gather_state_dict` gives one process's names and shapes.
    On 1 x 2 the update is taken again with a fault planted
    (`TP_FAULTS`): the global norm counting the replicated gradients M
    times, and the gradients' mean over the whole world instead of the
    data group; each is caught."""
    import chip_smoke

    assert (LOSS_RTOL, GRAD_RTOL, BN_RTOL) == (chip_smoke.MD_LOSS_RTOL, chip_smoke.MD_GRAD_RTOL, chip_smoke.MD_BN_RTOL)
    faults = (world, model_parallel) == (2, 2)
    ranks = dist_common.run_ranks(dist_common.tp_step_rank, world, tmp_path, model_parallel, STEP_SEED, STEP_SIZE,
                                  STEP_MIN_DIM, faults)
    D = world // model_parallel
    assert [r["grid"] for r in ranks] == [(i // model_parallel, i % model_parallel, D) for i in range(world)]
    assert all(r["local_batch"] == 2 // D for r in ranks)
    errs = ranks[0]["errors"]
    past, _ = chip_smoke.md_within_bounds(errs)
    assert not past, chip_smoke.md_error_summary(errs)
    specs = ranks[0]["specs"]
    assert len(specs) == STEP_PARAMS
    assert ranks[0]["state_dict"] == {"names_and_shapes": True, "params_equal": True}
    assert all(r["digests"]["replicated"] == ranks[0]["digests"]["replicated"] for r in ranks)
    for r in ranks:
        same_block = ranks[r["grid"][1]]  # data index 0's rank of this model index
        assert r["digests"]["sharded"] == same_block["digests"]["sharded"]
    if model_parallel == 3:  # short last blocks: ceil(n / 3), the rest to the last rank
        fc1 = "backbone.layers.1.blocks.0.mlp.fc1.weight"  # (128, 32), by output rows
        assert [r["blocks"][fc1] for r in ranks] == [(43, 32), (43, 32), (42, 32)]
    assert ranks[0]["digests"]["sharded"] != ranks[1]["digests"]["sharded"]
    if faults:
        planted = ranks[0]["planted"]
        assert sorted(planted) == sorted(dist_common.TP_FAULTS)
        assert "loss grad_norm" in planted["norm_counted_M_times"]
        # the blocks of a sharded parameter mixed: its gradient, moments and update are wrong
        fc1 = "grad backbone.layers.1.blocks.0.mlp.fc1.weight"
        assert fc1 in planted["gradient_mean_over_the_world"]
