"""fresco_torch.core (counterpart of fresco_tpu.core)."""
