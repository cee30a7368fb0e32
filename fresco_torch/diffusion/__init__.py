"""fresco_torch.diffusion (counterpart of fresco_tpu.diffusion)."""
