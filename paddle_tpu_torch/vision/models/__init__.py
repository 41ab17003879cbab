"""Vision models of the port (``paddle_tpu.vision.models`` counterparts):
the ResNet family, PP-YOLOE, CRNN and PP-OCRv3's SVTR recognizer."""
from .crnn import CRNN, CTCHeadLoss, crnn, ctc_greedy_decode
from .flops import conv_flops
from .ppocr import SVTRRec, ppocrv3_rec
from .ppyoloe import PPYOLOE, PPYOLOELoss, ppyoloe_crn_s, ppyoloe_s
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnet_conv_flops,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2", "resnet_conv_flops",
           "conv_flops", "CRNN", "CTCHeadLoss", "crnn", "ctc_greedy_decode", "PPYOLOE",
           "PPYOLOELoss", "ppyoloe_s", "ppyoloe_crn_s", "SVTRRec",
           "ppocrv3_rec"]
