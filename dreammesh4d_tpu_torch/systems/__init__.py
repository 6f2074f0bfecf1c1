"""systems of the PyTorch port (see dreammesh4d_tpu/systems)."""
