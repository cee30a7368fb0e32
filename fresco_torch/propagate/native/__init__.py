"""The C++ serpentine patch-synthesis backend, built with g++ at first use."""
from fresco_torch.propagate.native.binding import build_library, is_available, synthesize_level_native

__all__ = ["build_library", "is_available", "synthesize_level_native"]
