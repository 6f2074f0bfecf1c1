"""scripts of the PyTorch port (see the repository's scripts/), each run as
``python3 -m dreammesh4d_tpu_torch.scripts.<name>``."""
