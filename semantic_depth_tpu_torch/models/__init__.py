"""Networks of the PyTorch port: FCN-8s (VGG16) and Monodepth (vgg, resnet50),
each with its native full-resolution ``input_s2d`` variant, and DPT-Large
(``DPT``) as the depth network."""

from .dpt import DPT
from .fcn8s import FCN8s
from .monodepth import Monodepth, flip_average_postprocess

__all__ = ["DPT", "FCN8s", "Monodepth", "flip_average_postprocess"]
