"""PyTorch + CUDA port of `uni_encoder_tpu` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; this package imports
nothing from it (nor jax/flax) and keeps its own copies of what it needs.
Public functions keep the JAX layouts: images go in as (B, H, W, 3) and
`pred_masks` comes out as (B, Q, H/4, W/4).

Entry points run on CUDA unless the caller passes `device="cpu"`; with no
device and no visible GPU they raise instead of falling back to the CPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
