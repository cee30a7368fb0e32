"""Propagation: guided patch synthesis and blending (PyTorch port)."""
