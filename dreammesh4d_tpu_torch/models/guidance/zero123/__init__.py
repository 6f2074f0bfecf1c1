"""Stable Zero123 guidance: UNet, VAE, CLIP ViT, noise schedule and SDS
(counterpart of ``dreammesh4d_tpu/models/guidance/zero123``)."""
