"""models geometry of the PyTorch port (see dreammesh4d_tpu/models/geometry)."""
