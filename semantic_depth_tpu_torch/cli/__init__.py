"""Command-line entry points of the PyTorch port, mirroring the JAX package's:

* ``python -m semantic_depth_tpu_torch.cli.semantic_depth``: one frame with
  the full artifact suite, or the Munich focal-length sweep (reference
  semantic_depth.py);
* ``python -m semantic_depth_tpu_torch.cli.sequence``: a video sequence, one
  frame at a time or ``--batch N`` (reference
  semantic_depth_cityscapes_sequence.py).

Both run on the card (``--CUDA_DEVICE_NUMBER`` picks it) unless given
``--device cpu``, and read ``.msgpack`` weights written by either package's
``save_params``. The PLY outlier-removal tool is
``python -m semantic_depth_tpu_torch.utils.outlier_removal``.
"""
