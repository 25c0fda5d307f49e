from .detector import CenterNetDetector, create_detector, decode_detections
from .moe import MoEBlock, MoEClassifier, MoEFFN, create_moe
from .resnet import ResNet, create_resnet
from .seqformer import (SeqFormer, SeqFormerLM, attention_for,
                        create_seqformer, create_seqformer_lm)
from .unet import ConvBlock, UNet, create_unet, segment_logits_to_classes
from .vit import ViT, create_vit

__all__ = ["CenterNetDetector", "create_detector", "decode_detections",
           "MoEBlock", "MoEClassifier", "MoEFFN", "create_moe",
           "ResNet", "create_resnet",
           "ConvBlock", "UNet", "create_unet", "segment_logits_to_classes",
           "SeqFormer", "SeqFormerLM", "attention_for", "create_seqformer",
           "create_seqformer_lm",
           "ViT", "create_vit"]
