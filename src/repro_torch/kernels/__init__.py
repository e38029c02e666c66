"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions (``ref.py``) and the model-layout wrappers that pick between them
by the device of their tensors (``ops.py``)."""
