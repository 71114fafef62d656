"""semantic_depth_tpu_torch: the PyTorch/CUDA port of SemanticDepth for one
NVIDIA H100, beside the JAX package ``semantic_depth_tpu`` that it is held
against.

SemanticDepth measures the width of the road at a chosen depth in front of a
monocular camera: FCN-8s segmentation and monodepth disparity are fused,
back-projected into a point cloud, denoised, and measured (road width "rw"
or fence-to-fence "f2f").

This package ports the fused frame program (``pipeline.SemanticDepthPipeline``
with ``process_frame`` / ``process_batch`` / ``process_frame_staged``), its
frozen form (``export.py``), the CLIs, the trainers and the tools. The four
TPU kernels on its paths are hand-written CUDA C++ for ``sm_90a`` under
``csrc/``, built by ``nvcc`` at first use and bound with ``ctypes``
(``ops/_cuda.py``), each a dispatcher op (``torch.ops.sd_torch.*``) beside
its plain PyTorch version, which CPU tensors take. The package imports
nothing of JAX or of ``semantic_depth_tpu``.
"""

__version__ = "0.1.0"

from .config import (  # noqa: E402
    CAMERA_CITYSCAPES,
    CAMERA_CITYSCAPES_SEQUENCE,
    CAMERA_MUNICH,
    CameraConfig,
    PipelineConfig,
    TrainConfig,
    cityscapes_pipeline_config,
    munich_pipeline_config,
    sequence_pipeline_config,
)
from .export import export_pipeline, load_pipeline  # noqa: E402
from .pipeline import FrameOutputs, SemanticDepthPipeline  # noqa: E402

__all__ = [
    "CAMERA_CITYSCAPES",
    "CAMERA_CITYSCAPES_SEQUENCE",
    "CAMERA_MUNICH",
    "CameraConfig",
    "FrameOutputs",
    "PipelineConfig",
    "SemanticDepthPipeline",
    "TrainConfig",
    "cityscapes_pipeline_config",
    "export_pipeline",
    "load_pipeline",
    "munich_pipeline_config",
    "sequence_pipeline_config",
    "__version__",
]
