"""Diffusion guidance models (counterpart of ``dreammesh4d_tpu/models/guidance``)."""
