"""Command-line entry points of the PyTorch port, mirroring the JAX package's:

* ``python -m semantic_depth_tpu_torch.cli.semantic_depth``: one frame with
  the full artifact suite, or the Munich focal-length sweep (reference
  semantic_depth.py);
* ``python -m semantic_depth_tpu_torch.cli.sequence``: a video sequence, one
  frame at a time or ``--batch N`` (reference
  semantic_depth_cityscapes_sequence.py).

Both serve from a program of ``python -m
semantic_depth_tpu_torch.cli.export_pipeline`` with ``--use_frozen PATH``.
They run on the card (``--CUDA_DEVICE_NUMBER`` picks it) unless given
``--device cpu``, and read ``.msgpack`` weights written by either package's
``save_params``. The training CLIs are ``cli.fcn`` and
``cli.monodepth_train``; the tools ``cli.monodepth_infer``,
``cli.segment_video``, ``utils.video``, ``utils.render_ply`` and the PLY
outlier removal ``utils.outlier_removal``.
"""
