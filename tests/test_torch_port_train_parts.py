"""The port's training parts against the JAX package, on the CPU in fp32:
grid_sample, drop_path, train-mode BatchNorm, the text encoder, the matcher,
the set criterion, the monodepth loss and the optimizer update.

Inputs are made with numpy from seeds. Every random draw is made with
jax.random in the JAX code's own split order and handed to both sides
(torch cannot reproduce jax.random). Tolerances are stated per test.
"""

import dataclasses

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


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


# ----------------------------------------------------------------- grid_sample
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_and_gradients(padding_mode, align_corners):
    """Output and the gradients with respect to the input and the grid, with
    a fifth of the grid outside [-1, 1] (zero padding, or a clamped border
    coordinate with no gradient). atol/rtol 1e-5."""
    from uni_encoder_tpu.ops import grid_sample as jgrid
    from uni_encoder_tpu_torch.ops import grid_sample

    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 9, 3).astype(np.float32)
    grid = rng.uniform(-1.25, 1.25, size=(2, 5, 6, 2)).astype(np.float32)
    cot = rng.randn(2, 5, 6, 3).astype(np.float32)

    def f(x, g):
        return jgrid(x, g, align_corners=align_corners, padding_mode=padding_mode)

    ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(grid))
    dx_ref, dg_ref = vjp(jnp.asarray(cot))

    tx, tg = t(x).requires_grad_(True), t(grid).requires_grad_(True)
    out = grid_sample(tx, tg, align_corners=align_corners, padding_mode=padding_mode)
    out.backward(t(cot))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tg.grad), np.asarray(dg_ref), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------- drop_path
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_drop_path_with_given_mask(rate):
    """The port's drop_path with the keep mask JAX's drop_path draws: equal
    (one multiply and one divide in the same order)."""
    from uni_encoder_tpu.models.layers import drop_path as jdrop
    from uni_encoder_tpu_torch.models.layers import drop_path

    x = np.random.RandomState(1).randn(8, 4, 5, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jdrop(jnp.asarray(x), rate, False, key)
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - rate, (8, 1, 1, 1))).reshape(8).astype(np.float32)
    np.testing.assert_array_equal(_np(drop_path(t(x), rate, t(mask))), np.asarray(ref))
    assert drop_path(t(x), rate, None) is not None and torch.equal(drop_path(t(x), rate, None), t(x))


# --------------------------------------------------------- train-mode BatchNorm
def test_frozen_batchnorm_train_mode():
    """Batch statistics, their gradients and the running update (momentum
    0.9, unbiased variance) against the JAX FrozenBatchNorm with
    use_running_average=False. atol 1e-5, rtol 1e-5."""
    from uni_encoder_tpu.models.layers import FrozenBatchNorm as JBN
    from uni_encoder_tpu_torch.models.layers import FrozenBatchNorm

    rng = np.random.RandomState(2)
    C = 6
    x = (rng.randn(3, 5, 4, C) * 2 + 0.5).astype(np.float32)
    cot = rng.randn(3, 5, 4, C).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32)
    mean0, var0 = (0.1 * rng.randn(C)).astype(np.float32), (1 + 0.1 * rng.rand(C)).astype(np.float32)

    bn = JBN(C, use_running_average=False)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def f(x, scale, bias):
        return bn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats}, x,
                        mutable=["batch_stats"])

    ref, mut = f(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    _, vjp = jax.vjp(lambda *a: f(*a)[0], jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    dx, dscale, dbias = vjp(jnp.asarray(cot))

    m = FrozenBatchNorm(C).train()
    m.load_state_dict({"weight": t(scale), "bias": t(bias), "running_mean": t(mean0), "running_var": t(var0)})
    assert sorted(m.state_dict()) == ["bias", "running_mean", "running_var", "weight"]
    tx = t(x).requires_grad_(True)
    out = m(tx)
    out.backward(t(cot))
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **tol)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx), **tol)
    np.testing.assert_allclose(_np(m.weight.grad), np.asarray(dscale), **tol)
    np.testing.assert_allclose(_np(m.bias.grad), np.asarray(dbias), **tol)
    np.testing.assert_allclose(_np(m.running_mean), np.asarray(mut["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(_np(m.running_var), np.asarray(mut["batch_stats"]["var"]), **tol)
    m.eval()  # eval mode: the stored statistics, no update
    before = m.running_var.clone()
    ref_eval = bn.clone(use_running_average=True).apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": mut["batch_stats"]}, jnp.asarray(x))
    np.testing.assert_allclose(_np(m(t(x))), np.asarray(ref_eval), **tol)
    assert torch.equal(m.running_var, before)


# ---------------------------------------------------------------- text encoder
def test_text_encoder():
    """The JAX trainer's _TextEncoder on (B, N, L) tokens, its weights carried
    across by engine/convert.py (loaded strictly): texts with the prompt
    context appended, and logit_scale. atol 1e-5, rtol 1e-4."""
    from uni_encoder_tpu.training.train_step import _TextEncoder
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder
    from uni_encoder_tpu_torch.models.text_transformer import TextProjector, TextTransformer

    L, width, layers, vocab, hidden, n_ctx = 12, 64, 2, 300, 32, 3
    rng = np.random.RandomState(4)
    tokens = rng.randint(1, vocab, size=(2, 5, L)).astype(np.int64)
    tokens[..., 7] = vocab - 1  # the end-of-text token is the largest id
    tokens[0, 1, 3] = vocab - 1  # an earlier end-of-text: the first one counts
    enc = _TextEncoder(context_length=L, width=width, layers=layers, vocab_size=vocab, hidden_dim=hidden,
                       proj_num_layers=2, n_ctx=n_ctx)
    params = jax.jit(enc.init)(jax.random.PRNGKey(0), jnp.asarray(tokens, jnp.int32))["params"]
    ref = enc.apply({"params": params}, jnp.asarray(tokens, jnp.int32))

    holder = torch.nn.Module()
    holder.text_encoder = TextTransformer(L, width, layers, vocab)
    holder.text_projector = TextProjector(width, hidden, 2)
    holder.prompt_ctx = torch.nn.Embedding(n_ctx, hidden)
    holder.logit_scale = torch.nn.Parameter(torch.zeros(()))
    holder.load_state_dict(state_dict_from_jax({}, text_params=params), strict=True)
    got = UniEncoder.encode_text(holder, t(tokens))
    assert tuple(got["texts"].shape) == (2, 5 + n_ctx, hidden)
    np.testing.assert_allclose(_np(got["texts"]), np.asarray(ref["texts"]), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(got["logit_scale"]), np.asarray(ref["logit_scale"]), rtol=1e-7)


# --------------------------------------------------------------------- matcher
def _seg_targets(rng, B, N, H, W, K, n_valid):
    labels = rng.randint(0, K, size=(B, N))
    yy, xx = np.mgrid[0:H, 0:W]
    masks = np.zeros((B, N, H, W), bool)
    for b in range(B):
        for n in range(N):
            cy, cx, r = rng.randint(0, H), rng.randint(0, W), rng.uniform(2, 6)
            masks[b, n] = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    valid = np.zeros((B, N), bool)
    valid[:, :n_valid] = True
    return labels, masks, valid


@pytest.mark.parametrize("n_valid", [4, 2])
def test_hungarian_match(n_valid):
    """The assignment of every valid target slot equals the JAX matcher's
    (optax's solver there, scipy's here, on the same costs). A padded slot
    costs BIG_COST against every query, so its assignment is arbitrary in
    both and is not compared."""
    from uni_encoder_tpu.training.matcher import hungarian_match as jmatch
    from uni_encoder_tpu_torch.training.matcher import assign_on_host, hungarian_match

    rng = np.random.RandomState(5 + n_valid)
    B, Q, K, N, H, W, P = 2, 7, 5, 4, 16, 20, 64
    logits = (rng.randn(B, Q, K + 1) * 2).astype(np.float32)
    masks = (rng.randn(B, Q, H, W) * 3).astype(np.float32)
    labels, tmasks, valid = _seg_targets(rng, B, N, H, W, K, n_valid)
    key = jax.random.PRNGKey(9)
    ref, _ = jmatch(jnp.asarray(logits), jnp.asarray(masks), jnp.asarray(labels), jnp.asarray(tmasks),
                    jnp.asarray(valid), key, num_points=P)
    points = np.asarray(jax.random.uniform(key, (B, P, 2)))
    copies = assign_on_host.copies
    got, _ = hungarian_match(t(logits), t(masks), t(labels), t(tmasks), t(valid), t(points))
    assert assign_on_host.copies == copies + 1
    ref = np.asarray(ref)
    np.testing.assert_array_equal(got.numpy()[valid], ref[valid])
    for b in range(B):  # a matching: distinct queries
        assert len(set(got[b].tolist())) == N


# ------------------------------------------------------------------- criterion
def _criterion_draws(key, n_sets, B, M, P, n_sampled, n_random):
    """criterion.py's split order: per set (rng, r_match, r_pts); the
    matcher's points from r_match; (r1, r2) = split(r_pts) for the
    oversampled and uniform points."""
    draws = []
    for _ in range(n_sets):
        key, r_match, r_pts = jax.random.split(key, 3)
        r1, r2 = jax.random.split(r_pts)
        draws.append({"match": t(np.asarray(jax.random.uniform(r_match, (B, P, 2)))),
                      "oversampled": t(np.asarray(jax.random.uniform(r1, (M, n_sampled, 2)))),
                      "uniform": t(np.asarray(jax.random.uniform(r2, (M, n_random, 2))))})
    return draws


def test_set_criterion():
    """Every loss_* term (three prediction sets, contrastive with a learned
    logit scale, one padded target slot) at rtol 1e-5, atol 1e-6, and the
    total's gradients with respect to the predictions at atol 1e-6, rtol
    1e-4."""
    from uni_encoder_tpu.training.criterion import SetCriterion as JCriterion
    from uni_encoder_tpu_torch.training.criterion import SetCriterion

    rng = np.random.RandomState(6)
    B, Q, K, N, H, W, C, P = 2, 6, 5, 4, 16, 20, 8, 50
    sets = [((rng.randn(B, Q, K + 1) * 2).astype(np.float32), (rng.randn(B, Q, H, W) * 3).astype(np.float32))
            for _ in range(3)]
    queries = rng.randn(B, Q, C).astype(np.float32)
    texts = rng.randn(B, Q, C).astype(np.float32)
    logit_scale = np.float32(np.log(1 / 0.07))
    labels, tmasks, valid = _seg_targets(rng, B, N, H, W, K, 3)
    kw = dict(num_classes=K, num_points=P)
    jc, pc = JCriterion(**kw), SetCriterion(**kw)

    def jloss(sets, queries, scale):
        outs = {"pred_logits": sets[-1][0], "pred_masks": sets[-1][1], "contrastive_logits": queries,
                "aux_outputs": [{"pred_logits": a, "pred_masks": b} for a, b in sets[:-1]]}
        tg = {"labels": jnp.asarray(labels), "masks": jnp.asarray(tmasks), "valid": jnp.asarray(valid),
              "text_feats": jnp.asarray(texts), "logit_scale": scale}
        return jc(jax.random.PRNGKey(2), outs, tg)

    jsets = [tuple(jnp.asarray(a) for a in s) for s in sets]
    ref, vjp = jax.vjp(jloss, jsets, jnp.asarray(queries), jnp.asarray(logit_scale))
    cot = {k: jnp.ones_like(v) if k == "loss_total" else jnp.zeros_like(v) for k, v in ref.items()}
    dsets, dq, dscale = vjp(cot)

    tsets = [tuple(t(a).requires_grad_(True) for a in s) for s in sets]
    tq, tscale = t(queries).requires_grad_(True), torch.tensor(logit_scale, requires_grad=True)
    outs = {"pred_logits": tsets[-1][0], "pred_masks": tsets[-1][1], "contrastive_logits": tq,
            "aux_outputs": [{"pred_logits": a, "pred_masks": b} for a, b in tsets[:-1]]}
    tg = {"labels": t(labels), "masks": t(tmasks), "valid": t(valid), "text_feats": t(texts), "logit_scale": tscale}
    draws = _criterion_draws(jax.random.PRNGKey(2), 3, B, B * N, P, pc.n_sampled, P - pc.n_uncertain)
    got = pc(outs, tg, draws)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    got["loss_total"].backward()
    for (ta, tb), (da, db) in zip(tsets, dsets):
        np.testing.assert_allclose(_np(ta.grad), np.asarray(da), atol=1e-6, rtol=1e-4)
        np.testing.assert_allclose(_np(tb.grad), np.asarray(db), atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(_np(tq.grad), np.asarray(dq), atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(_np(tscale.grad), np.asarray(dscale), atol=1e-6, rtol=1e-4)


# -------------------------------------------------------------- monodepth loss
def _monodepth_case(rng, B, H, W, S):
    def sig(*shape):
        return (1 / (1 + np.exp(-rng.randn(*shape)))).astype(np.float32)

    outputs = {"disps": {s: sig(B, H >> s, W >> s, 1) for s in range(S)}, "cam_T_cam": {},
               "complete_flow": {}, "motion_mask": {}, "motion_prob": {}}
    for f in (-1, 1):
        T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        T[:, :3, 3] = 0.05 * rng.randn(B, 3)
        T[:, :3, :3] += 0.01 * rng.randn(B, 3, 3)
        outputs["cam_T_cam"][f] = T.astype(np.float32)
        for s in range(S):
            h, w = H >> s, W >> s
            outputs["complete_flow"][(f, s)] = (0.05 * rng.randn(B, h, w, 3)).astype(np.float32)
            prob = (0.5 * rng.randn(B, h, w, 1)).astype(np.float32)
            outputs["motion_prob"][(f, s)] = prob
            outputs["motion_mask"][(f, s)] = (1 / (1 + np.exp(-prob))).astype(np.float32)
    K = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 0.6 * W, 0.9 * H, W / 2, H / 2
    targets = {"color": {f: rng.rand(B, H, W, 3).astype(np.float32) for f in (0, -1, 1)},
               "K": K, "inv_K": np.linalg.inv(K).astype(np.float32)}
    return outputs, targets


def _monodepth_draws(key, B, H, W, sizes):
    """monodepth.py's split order: per scale (rng, r_noise, r_ground); the
    (B, H, W, F) noise from r_noise, the RANSAC indices from r_ground."""
    from uni_encoder_tpu_torch.training.monodepth import ground_rows

    noise, idx, n_ground = [], [], []
    for h, w in sizes:
        key, rn, rg = jax.random.split(key, 3)
        n = ground_rows(h) * w
        noise.append(t(np.asarray(jax.random.normal(rn, (B, H, W, 2)))))
        idx.append(torch.from_numpy(np.asarray(jax.random.randint(rg, (B, 100, 5), 0, n)).astype(np.int64)))
        n_ground.append(n)
    return {"noise": noise, "ransac_idx": idx, "n_ground": n_ground}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# d_ground's ground plane solves 3x3 normal equations of 5 points in fp32,
# whose condition number is in the thousands: on identical points the two
# frameworks' LAPACK calls give planes 3e-4 apart (relative), and d_ground and
# the total inherit that
MONODEPTH_RTOL = {"monodepth/d_ground": 2e-3, "loss_monodepth": 5e-4}


@pytest.mark.parametrize("step", [0, 10000])
def test_monodepth_loss(step):
    """Every monodepth/* term at rtol 1e-4 (atol 1e-6) but d_ground and the
    total (MONODEPTH_RTOL), over three scales of a 24 x 40 frame triple,
    before the ramp (step 0) and on it (step 10000); and the total's
    gradients with respect to every output at atol 1e-5, rtol 1e-3."""
    from uni_encoder_tpu.training.monodepth import monodepth_loss as jloss
    from uni_encoder_tpu_torch.training.monodepth import monodepth_loss

    B, H, W, S = 2, 24, 40, 3
    outputs, targets = _monodepth_case(np.random.RandomState(7), B, H, W, S)
    key = jax.random.PRNGKey(5)
    jt = _tree_map(jnp.asarray, targets)

    @jax.jit
    def loss_and_grads(o):
        ref, vjp = jax.vjp(lambda o: jloss(key, o, jt, jnp.asarray(step)), o)
        return ref, vjp({k: jnp.ones_like(v) if k == "loss_monodepth" else jnp.zeros_like(v)
                         for k, v in ref.items()})[0]

    ref, grads = loss_and_grads(_tree_map(jnp.asarray, outputs))

    to = _tree_map(lambda a: t(a).requires_grad_(True), outputs)
    draws = _monodepth_draws(key, B, H, W, [(H >> s, W >> s) for s in range(S)])
    got = monodepth_loss(to, _tree_map(t, targets), step, draws)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), rtol=MONODEPTH_RTOL.get(k, 1e-4), atol=1e-6,
                                   err_msg=k)
    got["loss_monodepth"].backward()
    for group, tree in to.items():
        for k, v in tree.items():
            np.testing.assert_allclose(_np(v.grad), np.asarray(grads[group][k]), atol=1e-5, rtol=1e-3,
                                       err_msg=f"{group} {k}")


# ------------------------------------------------------------------- optimizer
@pytest.fixture(scope="module")
def train_trees():
    """The scaled profile's training model (text encoder included) with one
    random d2 state, and the JAX params / text_params of the same weights."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.training.train_step import _TextEncoder
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    torch.set_num_threads(1)
    model = UniEncoder(dataclasses.replace(common.make_cfg(TC), is_train=True), device="cpu")
    text_keys = ("text_encoder.", "text_projector.", "prompt_ctx.", "logit_scale")
    state = {k: v for k, v in common.random_d2_state(model).items() if not k.startswith(text_keys)}
    variables = common.jax_variables(state)
    te = JC.TextEncoderConfig()
    enc = _TextEncoder(context_length=te.context_length, width=te.width, layers=te.num_layers,
                       vocab_size=te.vocab_size, hidden_dim=common.CONV_DIM, proj_num_layers=te.proj_num_layers,
                       n_ctx=te.n_ctx)
    text_params = jax.jit(enc.init)(jax.random.PRNGKey(1), jnp.ones((1, 2, te.context_length), jnp.int32))["params"]
    state = {k: t(v) for k, v in state.items()}
    state.update(state_dict_from_jax({}, text_params=text_params))
    model.load_state_dict(state, strict=True)
    return model, variables["params"], text_params


def test_optimizer_buckets_match_jax(train_trees):
    """Every trainable parameter of the training model lands in the bucket
    the JAX trainer's _bucket_index gives its flax path (names mapped by
    engine/convert.py's table), and every one has a path."""
    from uni_encoder_tpu.training.train_step import _bucket_index
    from uni_encoder_tpu_torch.engine.convert import param_paths
    from uni_encoder_tpu_torch.training.train_step import bucket_index

    model, params, text_params = train_trees
    paths = param_paths(params, text_params)
    named = dict(model.named_parameters())
    assert sorted(paths) == sorted(named)
    counts = [0] * 4
    for name, p in named.items():
        col, path, _ = paths[name]
        leaf = (params if col == "params" else text_params)
        for k in path:
            leaf = leaf[k]
        jb = _bucket_index(("[0]" if col == "params" else "[1]",) + path, leaf)
        assert bucket_index(name, p) == jb, (name, path)
        counts[jb] += 1
    assert all(counts), counts  # all four buckets are used


@pytest.mark.parametrize("grad_scale", [1.0, 1e-6])
def test_optimizer_update_matches_jax(train_trees, grad_scale):
    """Two updates of the JAX trainer's make_optimizer against the port's
    FusedAdamW (both with their defaults), on the backbone, pixel decoder, query decoder, task MLP and
    text encoder (all four buckets): with the clip active (grad_scale 1) and
    inactive (1e-6). Parameters after each update at atol 1e-7, and within
    one fp32 ulp (rtol 2**-23): the global norm is summed in another order,
    so with the clip active a parameter near 1 may round one ulp apart."""
    from uni_encoder_tpu.training.train_step import make_optimizer as jmake
    from uni_encoder_tpu_torch.engine.convert import param_paths
    from uni_encoder_tpu_torch.training.train_step import FusedAdamW

    model, params, text_params = train_trees
    keep = ("backbone", "pixel_decoder", "predictor", "task_mlp")
    jp = ({k: v for k, v in params.items() if k in keep}, text_params)
    paths = {n: v for n, v in param_paths(*jp).items()}
    named = {n: p.detach().clone() for n, p in model.named_parameters() if n in paths}
    assert len(named) == len(paths)

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def to_port(x, kind):
        x = np.asarray(x)
        return x.T if kind == "linear" else x.transpose(3, 2, 0, 1) if kind == "conv" else x

    rng = np.random.RandomState(8)
    grads_np = {n: np.asarray(rng.randn(*p.shape) * grad_scale, np.float32) for n, p in named.items()}

    def to_jax_tree(values):
        trees = ({}, {})
        for n, (col, path, kind) in paths.items():
            v = values[n]
            v = v.T if kind == "linear" else v.transpose(2, 3, 1, 0) if kind == "conv" else v
            node = trees[0 if col == "params" else 1]
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = jnp.asarray(v)
        return trees

    jtx = jmake()
    jparams = to_jax_tree({n: p.numpy() for n, p in named.items()})
    jstate = jtx.init(jparams)
    opt = FusedAdamW()
    state = opt.init(named)
    for _ in range(2):
        jgrads = to_jax_tree(grads_np)
        updates, jstate = jtx.update(jgrads, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        for n, p in named.items():
            p.grad = torch.from_numpy(grads_np[n])
        opt.step(state, named)
        for n, (col, path, kind) in paths.items():
            ref = to_port(leaf(jparams[0 if col == "params" else 1], path), kind)
            np.testing.assert_allclose(named[n].numpy(), ref, atol=1e-7, rtol=2.0 ** -23, err_msg=n)
        grads_np = {n: np.asarray(g * 0.7 + 0.1 * grad_scale, np.float32) for n, g in grads_np.items()}
    assert state.count == 2 and int(jstate.count) == 2
