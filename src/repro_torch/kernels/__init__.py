"""Hand-written CUDA kernels for Hopper (sm_90a) with their wrappers and
plain PyTorch versions. See `build.py` for how they are compiled."""
