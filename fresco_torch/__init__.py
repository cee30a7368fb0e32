"""FRESCO video-to-video translation in PyTorch + CUDA (Hopper).

A port of ``fresco_tpu`` (JAX/Flax/Pallas), module for module at the
same paths: ``fresco_torch/ops/warp.py`` is the counterpart of
``fresco_tpu/ops/warp.py`` and so on.  The two Pallas kernels of the
keyframe-translation path are hand-written CUDA C++ for sm_90a under
``fresco_torch/csrc`` (built on first use by ``fresco_torch.kernels``);
each sits beside a plain PyTorch version of the same math.

Conventions at public functions (as in ``fresco_tpu``): NHWC images in
[-1,1], flow [B,H,W,2] as (dx,dy), occlusion [B,H,W] float with
1 = occluded.  This package imports ``torch`` and never ``jax``.
"""
