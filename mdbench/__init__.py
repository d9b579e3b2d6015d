"""The benchmark of the PyTorch and CUDA port (mdcommunity_tpu_torch): see
README.md and run.py."""
