"""Vision models of the port (``paddle_tpu.vision.models`` counterparts):
the classification zoo (LeNet, AlexNet, VGG, SqueezeNet, MobileNet v1 to
v3, ShuffleNetV2, DenseNet, GoogLeNet, InceptionV3 and the ResNet
family), the detectors YOLOv3 and PP-YOLOE, CRNN and PP-OCRv3's SVTR
recognizer."""
from .alexnet import AlexNet, alexnet
from .crnn import CRNN, CTCHeadLoss, crnn, ctc_greedy_decode
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet264)
from .flops import conv_flops
from .googlenet import GoogLeNet, googlenet
from .inceptionv3 import InceptionV3, inception_v3
from .lenet import LeNet
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .mobilenetv3 import (MobileNetV3Large, MobileNetV3Small,
                          mobilenet_v3_large, mobilenet_v3_small)
from .ppocr import SVTRRec, ppocrv3_rec
from .ppyoloe import PPYOLOE, PPYOLOELoss, ppyoloe_crn_s, ppyoloe_s
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnet_conv_flops,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_swish,
                           shufflenet_v2_x0_25, shufflenet_v2_x0_33,
                           shufflenet_v2_x0_5, shufflenet_v2_x1_0,
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .yolo import YOLOv3, YOLOv3Loss, yolov3

__all__ = [
    "ResNet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
    "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
    "wide_resnet50_2", "wide_resnet101_2",
    "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "MobileNetV1", "mobilenet_v1", "MobileNetV2", "mobilenet_v2",
    "MobileNetV3Large", "MobileNetV3Small", "mobilenet_v3_large",
    "mobilenet_v3_small",
    "LeNet", "AlexNet", "alexnet",
    "DenseNet", "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264",
    "SqueezeNet", "squeezenet1_0", "squeezenet1_1",
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "shufflenet_v2_swish",
    "GoogLeNet", "googlenet", "InceptionV3", "inception_v3",
    "YOLOv3", "YOLOv3Loss", "yolov3",
    "CRNN", "CTCHeadLoss", "crnn", "ctc_greedy_decode",
    "PPYOLOE", "PPYOLOELoss", "ppyoloe_s", "ppyoloe_crn_s",
    "SVTRRec", "ppocrv3_rec",
    "BasicBlock", "BottleneckBlock", "resnet_conv_flops", "conv_flops",
]
