"""PyTorch + CUDA port of rspnet_tpu for NVIDIA Hopper (sm_90a).

Imports torch and numpy only, never JAX or the rspnet_tpu package. Clips
enter public functions in the JAX package's NDHWC layout; the kernels in
``csrc/`` replace the JAX package's Pallas kernels and build at first use
into ``build/rspnet_tpu_torch/``.
"""
