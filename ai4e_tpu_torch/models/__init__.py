from .seqformer import SeqFormer, attention_for, create_seqformer
from .unet import ConvBlock, UNet, create_unet, segment_logits_to_classes

__all__ = ["ConvBlock", "UNet", "create_unet", "segment_logits_to_classes",
           "SeqFormer", "attention_for", "create_seqformer"]
