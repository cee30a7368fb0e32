"""fresco_torch.pipeline (counterpart of fresco_tpu.pipeline)."""
