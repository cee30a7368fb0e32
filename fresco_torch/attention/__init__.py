"""fresco_torch.attention (counterpart of fresco_tpu.attention)."""
