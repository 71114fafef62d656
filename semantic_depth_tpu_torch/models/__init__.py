"""Networks of the PyTorch port: FCN-8s (VGG16) and Monodepth (vgg)."""

from .fcn8s import FCN8s
from .monodepth import Monodepth, flip_average_postprocess

__all__ = ["FCN8s", "Monodepth", "flip_average_postprocess"]
