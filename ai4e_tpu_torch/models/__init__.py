from .detector import CenterNetDetector, create_detector, decode_detections
from .resnet import ResNet, create_resnet
from .seqformer import SeqFormer, attention_for, create_seqformer
from .unet import ConvBlock, UNet, create_unet, segment_logits_to_classes

__all__ = ["CenterNetDetector", "create_detector", "decode_detections",
           "ResNet", "create_resnet",
           "ConvBlock", "UNet", "create_unet", "segment_logits_to_classes",
           "SeqFormer", "attention_for", "create_seqformer"]
