"""3D Gaussian splatting rasterizer of the PyTorch port (see dreammesh4d_tpu/ops/gs)."""

from .rasterize import RasterizeOutput, RasterizerConfig, rasterize

__all__ = ["RasterizeOutput", "RasterizerConfig", "rasterize"]
