"""models renderers of the PyTorch port (see dreammesh4d_tpu/models/renderers)."""
