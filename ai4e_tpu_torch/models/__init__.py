from .unet import ConvBlock, UNet, create_unet, segment_logits_to_classes

__all__ = ["ConvBlock", "UNet", "create_unet", "segment_logits_to_classes"]
