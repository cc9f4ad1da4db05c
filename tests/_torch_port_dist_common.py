"""Rank functions of the port's multi-process CPU tests.

`run_ranks(fn, world, out_dir, *args)` starts `world` ranks with the port's
own launcher (`uni_encoder_tpu_torch/parallel/launch.py`: the `spawn`
context, gloo, a `file://` rendezvous under `out_dir`) and a time limit; a
rank that raises or dies fails the test instead of hanging it. Each rank
calls `fn(out_dir, *args)` in the process group, at one thread, and saves
what it computed to `out_dir/rank<r>.pt`, which `run_ranks` returns in rank
order. Nothing here imports jax: the ranks import only torch, numpy and the
port.
"""

import contextlib
import os
import types

import torch

from _torch_port_common import t, tree_map
from uni_encoder_tpu_torch.parallel import launch, mesh

RANK_TIMEOUT_S = 240


def run_ranks(fn, world, out_dir, *args, timeout_s=RANK_TIMEOUT_S):
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    launch.spawn(_one_thread, world, (fn, out_dir, *args), backend="gloo", rendezvous_dir=out_dir,
                 timeout_s=timeout_s)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _one_thread(fn, out_dir, *args):
    torch.set_num_threads(1)
    torch.save(fn(out_dir, *args), os.path.join(out_dir, f"rank{mesh.rank()}.pt"))


def rows(x):
    """This rank's rows of a global array (its contiguous block)."""
    return mesh.shard_batch(x, mesh.rank(), mesh.world())


# ------------------------------------------------------------------ SyncBN
def syncbn_rank(out_dir, x, cotangent):
    """Train-mode FrozenBatchNorm on this rank's rows of `x`: the output,
    the gradient of sum(out * cotangent) with respect to the rows, and the
    running statistics."""
    from uni_encoder_tpu_torch.models.layers import FrozenBatchNorm

    bn = FrozenBatchNorm(x.shape[-1]).train()
    xs = t(rows(x)).requires_grad_(True)
    out = bn(xs)
    (out * t(rows(cotangent))).sum().backward()
    return {"out": out.detach(), "grad": xs.grad, "mean": bn.running_mean.clone(), "var": bn.running_var.clone()}


# ------------------------------------------------- criterion and monodepth
def losses_rank(out_dir, crit, md):
    """The set criterion and the monodepth loss on this rank's rows of the
    global cases `crit` and `md` (inputs, targets and the global batch's
    draws): every term, and the gradients of `loss_total` and
    `loss_monodepth` with respect to this rank's inputs."""
    from uni_encoder_tpu_torch.training.criterion import SetCriterion
    from uni_encoder_tpu_torch.training.monodepth import monodepth_loss

    got = {}
    pc = SetCriterion(**crit["kwargs"])
    sets = [tuple(t(rows(a)).requires_grad_(True) for a in s) for s in crit["sets"]]
    q = t(rows(crit["queries"])).requires_grad_(True)
    scale = torch.tensor(crit["logit_scale"], requires_grad=True)
    outs = {"pred_logits": sets[-1][0], "pred_masks": sets[-1][1], "contrastive_logits": q,
            "aux_outputs": [{"pred_logits": a, "pred_masks": b} for a, b in sets[:-1]]}
    tg = {k: t(rows(crit[k])) for k in ("labels", "masks", "valid", "text_feats")}
    tg["logit_scale"] = scale
    draws = [{k: t(rows(v)) for k, v in d.items()} for d in crit["draws"]]
    terms = pc(outs, tg, draws)
    terms["loss_total"].backward()
    got["criterion"] = {k: v.detach() for k, v in terms.items()}
    got["criterion_grads"] = {"sets": [tuple(a.grad for a in s) for s in sets], "queries": q.grad,
                              "logit_scale": scale.grad}

    outputs = tree_map(lambda a: t(rows(a)).requires_grad_(True), md["outputs"])
    targets = tree_map(lambda a: t(rows(a)), md["targets"])
    d = md["draws"]
    draws = {"noise": [t(rows(x)) for x in d["noise"]], "ransac_idx": [t(rows(x)) for x in d["ransac_idx"]],
             "n_ground": d["n_ground"]}
    terms = monodepth_loss(outputs, targets, md["step"], draws)
    terms["loss_monodepth"].backward()
    got["monodepth"] = {k: v.detach() for k, v in terms.items()}
    got["monodepth_grads"] = tree_map(lambda a: a.grad, outputs)
    return got


# ------------------------------------------------------------ whole steps
def digests(state):
    """sha256 of the bytes of every parameter, gradient, buffer and
    optimizer moment of a TrainState, in a fixed order."""
    import hashlib

    tensors = [p for p in state.model.parameters()] + [p.grad for p in state.model.parameters() if p.grad is not None]
    tensors += list(state.model.buffers()) + [m for bucket in state.opt.mu + state.opt.nu for m in bucket]
    return [hashlib.sha256(x.detach().contiguous().numpy().tobytes()).hexdigest() for x in tensors]


def step_rank(out_dir, n_steps, seed, size):
    """tests/_torch_port_common.py's micro trainer (deterministic) on this
    rank's rows of its micro batches at `size` pixels: `n_steps` steps, draws
    from a generator seeded `seed` (the global batch's, as one process draws
    them). Before each of its steps rank 0 takes one process's step on the
    whole batch from its own state with the same draws, the group out of its
    sight (rank 1 waits for it in its first collective), and returns
    `chip_smoke.md_step_errors` of each step against it, and the quantities
    past `chip_smoke.md_within_bounds` of its step with a wrong update
    planted (`planted_faults`); every rank returns its state's `digests`
    after each step."""
    from unittest import mock

    import _torch_port_common as common
    import chip_smoke
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.training.train_step import Trainer

    batches = common.micro_batches(size)
    seg, seq = (tree_map(t, rows(b)) for b in batches)
    trainer = Trainer(common.micro_config(TC), device="cpu", deterministic=True)
    state, gen = trainer.init(seed=0), torch.Generator().manual_seed(seed)
    if mesh.rank() == 0:
        ref_seg, ref_seq = (tree_map(t, b) for b in batches)
        ref_state, ref_gen = trainer.init(seed=0), torch.Generator().manual_seed(seed)
    out = {"digests": [], "errors": [], "planted": []}
    for _ in range(n_steps):
        if mesh.rank() == 0:
            before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
            lrs = chip_smoke.step_lrs(trainer.optimizer, state)
            draws = trainer.make_draws(ref_gen, ref_seg, ref_seq, torch.device("cpu"))
            with mock.patch.object(mesh, "active", lambda: False):
                chip_smoke.copy_state(ref_state, state)
                ref = trainer.train_step(ref_state, ref_seg, ref_seq, draws=draws)
        got = trainer.train_step(state, seg, seq, gen)
        out["digests"].append(digests(state))
        if mesh.rank() == 0:
            out["errors"].append(chip_smoke.md_step_errors(got, ref, lrs))
            out["planted"].append({fault: chip_smoke.md_within_bounds(chip_smoke.md_step_errors(
                (wrong, got[1]), ref, lrs))[0] for fault, wrong in planted_faults(got[0], before).items()})
    return out


def planted_faults(state, before):
    """A TrainState-like copy of a step's `state` for each wrong update:
    the parameters moved 1% further than AdamW moved them (a learning rate
    1% high), and AdamW's first moments 1% high (a moment fed a wrong
    gradient). Each leaves the gradients, losses and BatchNorm statistics
    as they were."""
    import types

    def wrong(lr_factor=1.0, mu_factor=1.0):
        params = {}
        for k, p in state.model.named_parameters():
            params[k] = before[k] + lr_factor * (p.detach() - before[k])
            params[k].grad = p.grad
        buffers = dict(state.model.named_buffers())
        model = types.SimpleNamespace(named_parameters=lambda: iter(params.items()),
                                      named_buffers=lambda: iter(buffers.items()))
        opt = types.SimpleNamespace(names=state.opt.names, mu=[[m * mu_factor for m in b] for b in state.opt.mu],
                                    nu=state.opt.nu)
        return types.SimpleNamespace(model=model, opt=opt)

    return {"learning_rate_1%_high": wrong(lr_factor=1.01), "first_moment_1%_high": wrong(mu_factor=1.01)}


# ------------------------------------------------------------- entry points
def evaluate_rank(out_dir, argv):
    """`evaluate_torch.main(argv)` as one rank of the group: what it returns."""
    import evaluate_torch

    return evaluate_torch.main(argv)


def failing_rank(out_dir):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if mesh.rank() == 1:
        raise RuntimeError("rank 1 gives up")
    mesh.all_reduce_sum(torch.ones(1))


# ------------------------------------------------------ tensor parallelism
def tp_digests(state):
    """sha256 of the bytes of every parameter, gradient and optimizer moment
    of a TrainState, by whether the parameter is split over the model group
    (`parallel/tensor.py`), and of every buffer (replicated)."""
    import hashlib

    from uni_encoder_tpu_torch.parallel import tensor

    out = {"replicated": [], "sharded": []}
    moments = {n: [] for bucket in state.opt.names for n in bucket}
    for key in ("mu", "nu"):
        for names, bucket in zip(state.opt.names, getattr(state.opt, key)):
            for n, m in zip(names, bucket):
                moments[n].append(m)
    for name, p in state.model.named_parameters():
        kind = "replicated" if tensor.shard_of(p) is None else "sharded"
        for x in [p] + ([p.grad] if p.grad is not None else []) + moments[name]:
            out[kind].append(hashlib.sha256(x.detach().contiguous().numpy().tobytes()).hexdigest())
    out["replicated"] += [hashlib.sha256(b.contiguous().numpy().tobytes()).hexdigest()
                          for b in state.model.buffers()]
    return out


TP_FAULTS = ("norm_counted_M_times", "gradient_mean_over_the_world")


def tp_step_rank(out_dir, model_parallel, seed, size, min_dim, faults=False):
    """tests/_torch_port_common.py's micro trainer (deterministic) on a
    (world / M) x M grid (`mesh.init_grid(model_parallel)`): the parameters
    `tensor.selection(model, min_dim)` names split over the model
    group, this rank's data index's rows of its micro batches at `size`
    pixels, one step with draws from a generator seeded `seed`. Rank 0
    first takes one process's step on the whole batch from the same weights
    with the same draws (the group out of its sight), then the same step from
    images moved by one ulp (`chip_smoke.ulp_moved`) at the first's
    discrete choices (`pinned_choices`); the ranks take their step at the
    first's pose decoder ReLU gates (their rows of them). Rank 0 returns
    `chip_smoke.md_step_errors` of the ranks' step, its sharded parameters,
    gradients and moments gathered whole, against the first, with the
    ulp-moved step's as `spread` (what rounding alone moves:
    `md_within_bounds` allows twice it) and, as `extra`, how many gates the
    ranks' own pre-activations would have set otherwise. With `faults`, the
    step's update is taken again from the start with each of TP_FAULTS
    planted (its losses, gradients and parameters held, `update_errors`):
    the replicated gradients' squares summed over the model group as well
    (the global norm counting them M times), and the gradients' mean run
    over the whole world instead of the data group (mixing the
    blocks of a sharded parameter, from the rank's own gradients before the
    mean); rank 0 returns the quantities past `chip_smoke.md_within_bounds`
    of each. Every rank returns its `tp_digests`, its grid indices and the
    selection; rank 0 also whether `tensor.gather_state_dict` gives one
    process's names and shapes and the gathered parameters."""
    from unittest import mock

    import _torch_port_common as common
    import chip_smoke
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.parallel import tensor
    from uni_encoder_tpu_torch.training.train_step import Trainer

    mesh.init_grid(model_parallel)
    batches = common.micro_batches(size)
    seg, seq = (tree_map(t, mesh.shard_batch(b)) for b in batches)
    trainer = Trainer(common.micro_config(TC), device="cpu", deterministic=True)
    if mesh.rank() == 0:
        ref_seg, ref_seq = (tree_map(t, b) for b in batches)
        ref_state, moved_state = trainer.init(seed=0), trainer.init(seed=0)
        lrs = chip_smoke.step_lrs(trainer.optimizer, ref_state)
        draws = trainer.make_draws(torch.Generator().manual_seed(seed), ref_seg, ref_seq, torch.device("cpu"))
        with mock.patch.object(mesh, "active", lambda: False), pinned_choices() as pin:
            ref = trainer.train_step(ref_state, ref_seg, ref_seq, draws=draws)
            gates = pin()["pose_gates"]
            moved = trainer.train_step(moved_state, *chip_smoke.ulp_moved(ref_seg, ref_seq), draws=draws)
        spread = chip_smoke.md_step_errors(moved, ref, lrs)
        del moved, moved_state
        torch.save(gates, os.path.join(out_dir, "pose_gates.pt"))
    torch.distributed.barrier()
    # this rank's rows of one process's gates: the pose decoder's batch is its frame pairs' global batches
    # stacked, each split over the data axis
    gates = torch.load(os.path.join(out_dir, "pose_gates.pt"))
    D, b = mesh.data_world(), seg["images"].shape[0]

    def rows(g):
        return g.reshape(g.shape[0] // (D * b), D, b, *g.shape[1:])[:, mesh.data_rank()].reshape(-1, *g.shape[1:])
    model = trainer.build_model(seed=0)
    specs = tensor.shard_params(model, mesh.model_group(), min_dim)
    state = trainer.init(model=model)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    local = {}  # this rank's gradients before the mean over the data group
    reduce_gradients = mesh.all_reduce_gradients

    def saving(params, group=None):
        params = list(params)
        local.update({id(p): p.grad.clone() for p in params if p.grad is not None})
        reduce_gradients(params, group)

    with mock.patch.object(mesh, "all_reduce_gradients", saving), \
            pinned_choices({"pose_gates": gates}, rows) as pin:
        _, losses = trainer.train_step(state, seg, seq, torch.Generator().manual_seed(seed))
    flipped = mesh.all_reduce_sum(torch.tensor(float(pin.flipped)))
    whole = chip_smoke.snapshot(state, losses, gather=tensor.gather_param)
    state_dict = tensor.gather_state_dict(model)
    out = {"digests": tp_digests(state), "grid": (mesh.data_rank(), mesh.model_rank(), mesh.data_world()),
           "specs": specs, "local_batch": int(seg["images"].shape[0]),
           "blocks": {k: tuple(p.shape) for k, p in model.named_parameters() if tensor.shard_of(p)}}
    if mesh.rank() == 0:
        out["errors"] = chip_smoke.md_step_errors(whole, ref, lrs)
        out["errors"]["spread"] = spread
        out["errors"]["extra"] = {"pose_gates_flipped": int(flipped)}
        # the gathered state dict: one process's names and shapes, the gathered parameters' bytes
        ref_sd, params = ref_state.model.state_dict(), dict(whole[0].model.named_parameters())
        out["state_dict"] = {"names_and_shapes": {k: v.shape for k, v in state_dict.items()} == {
            k: v.shape for k, v in ref_sd.items()}, "params_equal": all(torch.equal(state_dict[k], p)
                                                                         for k, p in params.items())}
    if faults:
        params = dict(model.named_parameters())
        reduced = {k: p.grad.clone() for k, p in params.items() if p.grad is not None}
        any_shard = next(tensor.shard_of(p) for p in params.values() if tensor.shard_of(p))
        out["planted"] = {}
        for fault in TP_FAULTS:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(start[k])
                    p.grad = None if k not in reduced else (local[id(p)].clone() if fault == TP_FAULTS[1]
                                                            else reduced[k].clone())
            if fault == TP_FAULTS[1]:
                reduce_gradients(params.values(), None)
            opt = trainer.optimizer.init(params)
            with mock.patch.object(tensor, "shard_of", lambda p, f=tensor.shard_of: f(p) or any_shard) \
                    if fault == TP_FAULTS[0] else contextlib.nullcontext():
                norm = trainer.optimizer.step(opt, params)
            wrong = chip_smoke.snapshot(types.SimpleNamespace(model=model, opt=opt), {**losses, **norm},
                                        gather=tensor.gather_param)
            if mesh.rank() == 0:
                out["planted"][fault] = chip_smoke.md_within_bounds(update_errors(wrong, ref, lrs))[0]
    return out


@contextlib.contextmanager
def pinned_choices(given=None, rows=None):
    """The step's discrete choices made as they are until the function
    yielded is called (it returns them), then those made so far given again
    in the same order (one step's choices pinned for a second): the
    criterion's Hungarian matching and the mask losses' most uncertain
    points, and the pose decoder's ReLU gates (which elements pass, each
    ReLU call of its forwards in order: a pre-activation within rounding of
    0 passes in one process and not in another). `given`: choices pinned
    from the start ({key: list}, a key absent is made as it is), each gate
    taken through `rows` (this rank's rows of one process's). The yielded
    function's `flipped` counts the gates given that this process's own
    pre-activations would have set otherwise."""
    from unittest import mock

    from uni_encoder_tpu_torch.models.pose_decoder import ResNetLikePoseDecoder
    from uni_encoder_tpu_torch.training import criterion as criterion_module

    made = {"assign_on_host": [], "uncertainty_points": [], "pose_gates": []}
    replay = {k: [rows(g) for g in v] if k == "pose_gates" and rows else list(v) for k, v in (given or {}).items()}

    def pinnable(key, fn):
        def run(*args):
            out = fn(*args)
            made[key].append(out)
            return replay[key][len(made[key]) - 1] if key in replay else out
        return run

    relu, forward = torch.nn.functional.relu, ResNetLikePoseDecoder.forward

    def gated(x, inplace=False):
        made["pose_gates"].append(x.detach() > 0)
        if "pose_gates" not in replay:
            return relu(x, inplace)
        gate = replay["pose_gates"][len(made["pose_gates"]) - 1]
        pin.flipped += int((gate != made["pose_gates"][-1]).sum())
        return torch.where(gate, x, torch.zeros_like(x))

    def gated_forward(self, features):
        with mock.patch.object(torch.nn.functional, "relu", gated):
            return forward(self, features)

    def pin():
        replay.update({k: list(v) for k, v in made.items()})
        for v in made.values():
            v.clear()
        return replay

    pin.flipped = 0
    with contextlib.ExitStack() as stack:
        for key in ("assign_on_host", "uncertainty_points"):
            stack.enter_context(mock.patch.object(criterion_module, key, pinnable(key, getattr(criterion_module, key))))
        stack.enter_context(mock.patch.object(ResNetLikePoseDecoder, "forward", gated_forward))
        yield pin


def update_errors(got, ref, lrs):
    """The losses' (grad_norm and clip_scale among them), the gradients'
    and the parameters' part of `chip_smoke.md_step_errors` (what a wrong
    gradient or update moves; the moments' and statistics' groups left
    empty)."""
    import chip_smoke

    gp, rp = dict(got[0].model.named_parameters()), dict(ref[0].model.named_parameters())
    losses = {k: abs(float(v) - float(ref[1][k])) / max(abs(float(ref[1][k])), 1e-30) for k, v in got[1].items()}
    grads = chip_smoke.scale_aware_errors({k: p.grad for k, p in gp.items() if p.grad is not None},
                                          {k: p.grad for k, p in rp.items() if p.grad is not None})
    return {"losses": losses, "grads": grads, "params": chip_smoke.param_errors(gp, rp, lrs, losses["clip_scale"]),
            "moments": ({}, 0.0), "bn": {}}


def tp_module(kind, args):
    """A port module of tensor parallelism's module-parity cases."""
    from uni_encoder_tpu_torch.models.backbones.swin import PatchMerging, SwinBlock
    from uni_encoder_tpu_torch.models.pixel_decoders.msdeformattn import MSDeformAttnEncoderLayer
    from uni_encoder_tpu_torch.models.text_transformer import TextProjector, TextTransformer

    if kind == "swin_block":
        return SwinBlock(args["dim"], args["heads"], args["window"], args["shift"])
    if kind == "patch_merging":
        return PatchMerging(args["dim"])
    if kind == "encoder_layer":
        return MSDeformAttnEncoderLayer(args["dim"], args["ffn"], 3, args["heads"], 4)
    holder = torch.nn.Module()
    holder.text_encoder = TextTransformer(args["context"], args["width"], args["layers"], args["vocab"])
    holder.text_projector = TextProjector(args["width"], args["hidden"], 2)
    holder.prompt_ctx = torch.nn.Embedding(args["n_ctx"], args["hidden"])
    holder.logit_scale = torch.nn.Parameter(torch.zeros(()))
    return holder


def tp_module_forward(kind, module, args, inputs):
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder
    from uni_encoder_tpu_torch.models.pixel_decoders.msdeformattn import absolute_reference_points

    if kind == "encoder_layer":
        shapes = tuple(map(tuple, args["shapes"]))
        return module(inputs[0], inputs[1], absolute_reference_points(shapes, "cpu"), shapes)
    if kind == "text":
        return UniEncoder.encode_text(module, inputs[0])["texts"]
    return module(inputs[0])


def tp_modules_rank(out_dir, cases):
    """Each case (kind, args, state, inputs, cotangent, min_dim, extra) on a
    1 x world grid: the port's module loaded with `state`, its parameters
    split over the model group by `tensor.shard_params(min_dim, extra)`,
    the output and the gradients of sum(output * cotangent) with respect to
    the float inputs and to every parameter (gathered whole), and the
    sharded parameters' blocks' shapes."""
    from uni_encoder_tpu_torch.parallel import tensor

    mesh.init_grid(mesh.world())
    out = {}
    for name, (kind, args, state, inputs, cotangent, min_dim, extra) in cases.items():
        module = tp_module(kind, args)
        module.load_state_dict({k: t(v) for k, v in state.items()}, strict=True)
        specs = tensor.shard_params(module, mesh.model_group(), min_dim, extra)
        xs = [t(x).requires_grad_(True) if x.dtype.kind == "f" else t(x) for x in inputs]
        y = tp_module_forward(kind, module, args, xs)
        (y * t(cotangent)).sum().backward()
        out[name] = {"out": y.detach(), "dx": [x.grad for x in xs if x.requires_grad], "specs": specs,
                     "grads": {k: None if p.grad is None else tensor.gather_param(p, p.grad)
                               for k, p in module.named_parameters()},
                     "blocks": {k: tuple(p.shape) for k, p in module.named_parameters() if tensor.shard_of(p)}}
    return out
