"""Host file IO of the PyTorch port (numpy only)."""
