"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref.py``) and a dispatch layer that follows the tensor's device
(``ops.py``). The CUDA sources live in ``repro_torch/csrc``."""
