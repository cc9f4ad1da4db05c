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

import os

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
