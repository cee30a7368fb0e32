"""fresco_torch.utils (counterpart of fresco_tpu.utils)."""
