"""fresco_torch.ops (counterpart of fresco_tpu.ops)."""
