"""The benchmark of the PyTorch and CUDA prover (gkr_mimc_tpu_torch) on an NVIDIA H100."""
