"""numpy helpers of the PyTorch port."""
