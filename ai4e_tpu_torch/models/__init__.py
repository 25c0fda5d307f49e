from .detector import CenterNetDetector, create_detector, decode_detections
from .moe import MOE_EP_RULES, MoEBlock, MoEClassifier, MoEFFN, create_moe
from .resnet import ResNet, create_resnet, create_resnet50
from .seqformer import (SeqFormer, SeqFormerLM, attention_for,
                        create_seqformer, create_seqformer_lm)
from .unet import ConvBlock, UNet, create_unet, segment_logits_to_classes
from .vit import TP_RULES as VIT_TP_RULES
from .vit import ViT, create_vit

__all__ = ["CenterNetDetector", "create_detector", "decode_detections",
           "MOE_EP_RULES", "MoEBlock", "MoEClassifier", "MoEFFN",
           "create_moe", "ResNet", "create_resnet", "create_resnet50",
           "ConvBlock", "UNet", "create_unet", "segment_logits_to_classes",
           "SeqFormer", "SeqFormerLM", "attention_for", "create_seqformer",
           "create_seqformer_lm",
           "ViT", "VIT_TP_RULES", "create_vit"]
