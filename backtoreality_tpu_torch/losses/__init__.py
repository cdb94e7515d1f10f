"""Training criteria (the FSB recipe)."""

from backtoreality_tpu_torch.losses import votenet as votenet_losses

__all__ = ["votenet_losses"]
