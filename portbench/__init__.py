"""The benchmark of krepp_tpu_torch, the PyTorch and CUDA port: one cell
once, `python3 -m portbench.run` (see run.py and README.md)."""
