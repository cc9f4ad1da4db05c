"""One multi-task training step (port of
`uni_encoder_tpu/training/train_step.py`).

AdamW with 0.1x backbone LR, no weight decay on norms, biases and
embeddings, a whole-model gradient clip at 0.01 and the WarmupPolyLR
schedule; one step consumes a balanced segmentation + sequence batch and
minimizes

  L = L_set (CE + point mask BCE + dice, deep supervision, query-text
             contrastive) + L_monodepth (7 self-supervised terms).

PyTorch holds the state in modules: `TrainState.model` is a `UniEncoder`
built with `is_train` (it holds the text encoder too), updated in place,
with its BatchNorm statistics; `TrainState.opt` the optimizer's moments.

Random draws: `Trainer.make_draws` takes every random number of a step from
one `torch.Generator`, in a fixed order (the backbone's keep masks of the
segmentation and the sequence pass, the criterion's points per prediction
set, the monodepth noise and RANSAC indices per scale), so that a step is
reproducible and its draws can be handed to another implementation. Keep
masks, block by block in the backbone's order, rates on a linspace from 0
to the backbone's `drop_path_rate` over all blocks, a block's mask 1 with
probability 1 - rate:
  swin      (blocks, 2, B): the attention branch, then the MLP branch
  dinat     (blocks, 2, B): the attention branch, then the MLP branch
  convnext  (blocks, B): the residual branch after LayerScale
  resnet    None: it has no stochastic depth
The first block's rate is 0: it ignores its masks (the JAX copy draws none
for it).

Data parallelism: in a process group (`parallel/mesh.py`) each rank is
given its rows of the global batch (`mesh.shard_batch`) and takes the step
of the JAX trainer on N devices, which is the one-device step at the global
batch. Every rank draws the global batch's draws from the same generator and
keeps its rows (`shard_draws`; `drop_seq`'s batch axis is the frame-major
`cat([cur, prev, next])`, so a rank's rows there are three blocks). Its
loss is its share of the global loss (the train-mode BatchNorm statistics,
the criterion's normalizers and contrastive loss and m_sparsity are the
global batch's); its gradients are averaged over the ranks before the clip
and AdamW, so every rank makes the same update; and the reported losses
are their means over the ranks, the global values.

Determinism: `Trainer(cfg, deterministic=True)` takes each step with
cuDNN's benchmark off, `cudnn.deterministic` on and
`torch.use_deterministic_algorithms(True)`, and restores all three after
the step. Every op on the step's path then has a deterministic CUDA
backward (the deformable-sampling backward kernel sums in fixed point;
`grid_sample`, the SSIM pad and the InfoNCE term are written without
`F.grid_sample`, `ReflectionPad2d` and `NLLLoss`), so the same state,
batch and draws give the same bytes from process to process. On CUDA,
cuBLAS needs `CUBLAS_WORKSPACE_CONFIG=:4096:8` (or `:16:8`) in the
environment before the process's first cuBLAS call; the step raises
without it. The default keeps cuDNN's benchmark mode, which picks the
fastest convolution algorithms, so two processes may round differently.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..models.oneformer import UniEncoder
from ..parallel import mesh
from . import monodepth
from .criterion import SetCriterion

N_BUCKETS = 4  # (main / backbone LR group) x (no decay / decay)
CUBLAS_DETERMINISTIC_CONFIGS = (":4096:8", ":16:8")


def check_cublas_workspace_config() -> None:
    """Raise unless CUBLAS_WORKSPACE_CONFIG is one of the values with which
    cuBLAS runs deterministically. It has to be set before the process's
    first cuBLAS call, so the error says to set it at launch."""
    got = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if got not in CUBLAS_DETERMINISTIC_CONFIGS:
        raise RuntimeError(
            f"a deterministic step on CUDA needs CUBLAS_WORKSPACE_CONFIG={CUBLAS_DETERMINISTIC_CONFIGS[0]} "
            f"(or {CUBLAS_DETERMINISTIC_CONFIGS[1]}) in the environment before the process starts; got {got!r}")


@contextlib.contextmanager
def _algorithms(deterministic: bool):
    """cuDNN and PyTorch algorithm choice for one step, restored after it.

    Default: cuDNN's benchmark mode. cuDNN's heuristics give some fp32
    convolutions of the motion decoders (3x3, 192 channels at 48x128) an FFT
    algorithm ~500x slower than its implicit GEMM on an H100; a step's
    shapes are static, so benchmarking each convolution once, on the first
    step, is cheap. Deterministic: benchmark off, cuDNN's deterministic
    algorithms, and `torch.use_deterministic_algorithms(True)`."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    cudnn.benchmark = not deterministic
    if deterministic:
        cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = saved[0], saved[1]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def bucket_index(name: str, p: torch.Tensor) -> int:
    """The JAX copy's `_bucket_index` on the port's parameter names: backbone
    parameters in the 0.1x LR group; no decay for vectors, scalars and 2-D
    embeddings other than the patch embedding."""
    name = name.lower()
    backbone = "backbone" in name
    no_decay = p.ndim <= 1 or ("embed" in name and "patch" not in name and p.ndim == 2)
    return (2 if backbone else 0) + (0 if no_decay else 1)


@dataclasses.dataclass
class OptState:
    count: int
    names: List[List[str]]  # per bucket
    mu: List[List[torch.Tensor]]
    nu: List[List[torch.Tensor]]


class FusedAdamW:
    """AdamW + global-norm clip + poly LR over four buckets of parameters,
    each bucket updated with `torch._foreach_*` ops (a few multi-tensor
    kernels for the whole model). The update is the JAX copy's
    `make_optimizer`: the clip scale is exactly
    `1 if g < clip else clip / (g + 1e-16)`, the LR is taken at the count
    before the increment, and a parameter with no gradient counts as a zero
    gradient (weight decay still moves it)."""

    def __init__(self, base_lr: float = 1e-4, weight_decay: float = 0.05, backbone_multiplier: float = 0.1,
                 clip_value: float = 0.01, max_iter: int = 90000, poly_power: float = 0.9, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.base_lr, self.clip_value, self.max_iter, self.poly_power = base_lr, clip_value, max_iter, poly_power
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mults = (1.0, 1.0, backbone_multiplier, backbone_multiplier)
        self.decays = (0.0, weight_decay, 0.0, weight_decay)

    def lr_at(self, count: int) -> float:
        """The poly LR, in fp32 as the JAX copy computes it."""
        frac = np.float32(min(count, self.max_iter)) / np.float32(self.max_iter)
        return float(np.float32(self.base_lr) * (np.float32(1.0) - frac) ** np.float32(self.poly_power))

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        """Zero moments for `params` (name -> parameter), by bucket."""
        names: List[List[str]] = [[] for _ in range(N_BUCKETS)]
        for name, p in params.items():
            names[bucket_index(name, p)].append(name)
        zeros = lambda: [[torch.zeros_like(params[n]) for n in bucket] for bucket in names]  # noqa: E731
        return OptState(0, names, zeros(), zeros())

    @torch.no_grad()
    def step(self, state: OptState, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update of `params` (name -> parameter, gradients in `.grad`),
        in place. Returns the gradient's global norm and the clip scale."""
        ps = [[params[n] for n in bucket] for bucket in state.names]
        gs = [[p.grad if p.grad is not None else torch.zeros_like(p) for p in bucket] for bucket in ps]
        flat = [g for bucket in gs for g in bucket]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(flat))) if flat else torch.zeros(())
        scale = torch.where(gnorm < self.clip_value, 1.0, self.clip_value / (gnorm + 1e-16))
        count = state.count + 1
        # the bias corrections and the step size in fp32, as the JAX copy
        # computes them
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        lr = np.float32(self.lr_at(state.count))
        for i in range(N_BUCKETS):
            if not ps[i]:
                continue
            g = torch._foreach_mul(gs[i], scale)
            torch._foreach_mul_(state.mu[i], self.b1)
            torch._foreach_add_(state.mu[i], torch._foreach_mul(g, 1.0 - self.b1))
            torch._foreach_mul_(state.nu[i], self.b2)
            torch._foreach_add_(state.nu[i], torch._foreach_mul(torch._foreach_mul(g, 1.0 - self.b2), g))
            denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(state.nu[i], c2)), self.eps)
            step_dir = torch._foreach_div(torch._foreach_div(state.mu[i], c1), denom)
            if self.decays[i]:
                torch._foreach_add_(step_dir, torch._foreach_mul(ps[i], self.decays[i]))
            torch._foreach_add_(ps[i], torch._foreach_mul(step_dir, float(-lr * np.float32(self.mults[i]))))
        state.count = count
        return {"grad_norm": gnorm, "clip_scale": scale}


@dataclasses.dataclass
class TrainState:
    step: int
    model: UniEncoder
    opt: OptState


class Trainer:
    """Builds the model (with its text encoder), the criterion and the
    optimizer; `init` makes a TrainState and `train_step(state, seg_batch,
    seq_batch, generator)` takes one step in place.

    seg_batch: images (B, H, W, 3), task_tokens (B, 77), text_tokens
      (B, Q - n_ctx, 77), labels (B, N), masks (B, N, H/4, W/4), valid (B, N).
    seq_batch: images, prev_images, next_images (B, h, w, 3), K, inv_K (B, 4, 4).

    `deterministic=True` takes every step with deterministic algorithms
    only (see the module's docstring); the default is the fastest.
    """

    def __init__(self, cfg: Config, device: Optional[Union[str, torch.device]] = None,
                 deterministic: bool = False):
        model_cfg = cfg.model if cfg.model.is_train else dataclasses.replace(cfg.model, is_train=True)
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.device = device
        self.deterministic = deterministic
        of = model_cfg.one_former
        self.criterion = SetCriterion(
            num_classes=model_cfg.sem_seg_head.num_classes,
            class_weight=of.class_weight,
            mask_weight=of.mask_weight,
            dice_weight=of.dice_weight,
            no_object_weight=of.no_object_weight,
            contrastive_weight=of.contrastive_weight,
            contrastive_temperature=of.contrastive_temperature,
            num_points=of.train_num_points,
            oversample_ratio=of.oversample_ratio,
            importance_sample_ratio=of.importance_sample_ratio,
            deep_supervision=of.deep_supervision,
        )
        s = cfg.solver
        self.optimizer = FusedAdamW(base_lr=s.base_lr, weight_decay=s.weight_decay,
                                    backbone_multiplier=s.backbone_multiplier, clip_value=s.clip_gradients_value,
                                    max_iter=s.max_iter)

    # -------------------------------------------------------------- init
    def init(self, seed: int = 0, model: Optional[UniEncoder] = None) -> TrainState:
        """A fresh state: the model with random weights from `seed` (or the
        given training model, e.g. with a state dict loaded), zero moments."""
        if model is None:
            model = UniEncoder(self.model_cfg, device=self.device, seed=seed,
                               task_seq_len=self.cfg.input.task_seq_len)
        if not model.cfg.is_train:
            raise ValueError("the trainer needs a model built with is_train")
        return TrainState(0, model, self.optimizer.init(dict(model.named_parameters())))

    # ------------------------------------------------------------- draws
    def n_prediction_sets(self) -> int:
        of = self.model_cfg.one_former
        return of.dec_layers if of.deep_supervision else 1  # the seed and every round

    def make_draws(self, generator: torch.Generator, seg_batch: Dict, seq_batch: Dict,
                   device: torch.device, world: int = 1) -> Dict:
        """Every random number of one step, from `generator`, in a fixed
        order; drawn where the generator lives, then moved to `device`. With
        `world`, those of the global batch of `world` times the given
        batches' rows."""
        name = self.model_cfg.backbone.name
        backbone = getattr(self.model_cfg.backbone, name)

        def keep_masks(batch):
            if name == "resnet":  # no stochastic depth
                return None
            n_blocks = sum(backbone.depths)
            rates = torch.linspace(0.0, backbone.drop_path_rate, n_blocks, dtype=torch.float64)
            keep = (1.0 - rates).to(torch.float32)[:, None, None]
            u = torch.rand((n_blocks, 1 if name == "convnext" else 2, batch), generator=generator,
                           device=generator.device)
            masks = (u < keep.to(u.device)).to(torch.float32).to(device)
            return masks[:, 0] if name == "convnext" else masks

        B = seg_batch["images"].shape[0] * world
        Bs, H, W = seq_batch["images"].shape[:3]
        Bs *= world
        S = self.model_cfg.num_depth_scales
        return {
            "drop_seg": keep_masks(B),
            "drop_seq": keep_masks(3 * Bs),
            "criterion": self.criterion.make_draws(generator, self.n_prediction_sets(), B,
                                                   seg_batch["labels"].shape[1], device),
            "monodepth": monodepth.make_draws(generator, Bs, H, W, [(H >> s, W >> s) for s in range(S)],
                                              2, device),
        }

    @staticmethod
    def shard_draws(draws: Dict, rank: int, world: int) -> Dict:
        """Rank `rank`'s rows of the global batch's draws (`make_draws` with
        `world`): the contiguous block of each batch axis, and of
        `drop_seq`'s frame-major axis the block of each frame."""
        if world == 1:
            return draws

        def rows(x):  # the block along the first axis
            b = x.shape[0] // world
            return x[rank * b:(rank + 1) * b]

        def seq_rows(masks):  # (..., 3 * Bs): [cur | prev | next], each Bs wide
            if masks is None:
                return None
            frames = masks.reshape(*masks.shape[:-1], 3, world, -1)[..., rank, :]
            return frames.reshape(*masks.shape[:-1], -1)

        seg = draws["drop_seg"]
        md = draws["monodepth"]
        return {
            "drop_seg": None if seg is None else seg.reshape(*seg.shape[:-1], world, -1)[..., rank, :],
            "drop_seq": seq_rows(draws["drop_seq"]),
            # the mask losses' points are (B * N, ...): image-major, so a block too
            "criterion": [{k: rows(v) for k, v in d.items()} for d in draws["criterion"]],
            "monodepth": {"noise": [rows(x) for x in md["noise"]], "ransac_idx": [rows(x) for x in md["ransac_idx"]],
                          "n_ground": md["n_ground"]},
        }

    # -------------------------------------------------------------- step
    def losses(self, state: TrainState, seg_batch: Dict, seq_batch: Dict, draws: Dict) -> Dict[str, torch.Tensor]:
        """The step's forward: every loss term, and `loss`, their sum."""
        model = state.model
        seg_out = model.forward_segmentation(seg_batch["images"], seg_batch["task_tokens"], draws["drop_seg"])
        text = model.encode_text(seg_batch["text_tokens"])
        seg_targets = {"labels": seg_batch["labels"], "masks": seg_batch["masks"], "valid": seg_batch["valid"],
                       "text_feats": text["texts"], "logit_scale": text["logit_scale"]}
        seg_losses = self.criterion(seg_out, seg_targets, draws["criterion"])
        seq_out = model.forward_sequence_train(seq_batch["images"], seq_batch["prev_images"],
                                               seq_batch["next_images"], draws["drop_seq"])
        seq_targets = {"color": {0: seq_batch["images"], -1: seq_batch["prev_images"],
                                 1: seq_batch["next_images"]},
                       "K": seq_batch["K"], "inv_K": seq_batch["inv_K"]}
        seq_losses = monodepth.monodepth_loss(seq_out, seq_targets, state.step, draws["monodepth"])
        out = {**seg_losses, **seq_losses}
        out["loss_seg"] = seg_losses["loss_total"]
        out["loss"] = seg_losses["loss_total"] + seq_losses["loss_monodepth"]
        return out

    def train_step(self, state: TrainState, seg_batch: Dict, seq_batch: Dict,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict] = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step, in place: draws from `generator` (or the given draws),
        forward, backward, clip and AdamW update, BatchNorm statistics
        moved, `state.step` + 1. Returns the state and the detached losses
        (0-d tensors on the device; reading them waits for the step).

        In a process group the batches are this rank's rows of the global
        batch, the draws (made here, or given) the global batch's, and the
        gradients, the update and the losses returned the global batch's."""
        model = state.model
        device = next(model.parameters()).device
        if self.deterministic and device.type == "cuda":
            check_cublas_workspace_config()
        if draws is None:
            if generator is None:
                raise ValueError("give a generator or the draws")
            draws = self.make_draws(generator, seg_batch, seq_batch, device, world=mesh.world())
        draws = self.shard_draws(draws, mesh.rank(), mesh.world())
        model.train()
        model.zero_grad(set_to_none=True)
        with _algorithms(self.deterministic):
            losses = self.losses(state, seg_batch, seq_batch, draws)
            losses["loss"].backward()
            mesh.all_reduce_gradients(model.parameters())
            opt = self.optimizer.step(state.opt, dict(model.named_parameters()))
        state.step += 1
        metrics = {k: (v.detach() if torch.is_tensor(v) else torch.tensor(v)) for k, v in losses.items()}
        metrics = mesh.mean_over_ranks(metrics)
        metrics.update(opt)
        return state, metrics
