from .trainer import clamp_latent

__all__ = ["clamp_latent"]
