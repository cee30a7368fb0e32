"""fresco_torch.models (counterpart of fresco_tpu.models)."""
