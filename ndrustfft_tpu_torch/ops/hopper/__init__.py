"""Hand-written CUDA kernels for Hopper (sm_90a), their plain PyTorch
versions and their wrappers. Sources are in ``ndrustfft_tpu_torch/csrc``;
``_build`` compiles them with nvcc at first use."""
