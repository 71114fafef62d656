"""Trainers of the PyTorch port: FCN-8s (``trainer``) and monodepth
(``monodepth_trainer``), with their data loaders and metrics."""
