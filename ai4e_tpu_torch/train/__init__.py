from .step import Trainer, cross_entropy_loss, segmentation_loss

__all__ = ["Trainer", "cross_entropy_loss", "segmentation_loss"]
