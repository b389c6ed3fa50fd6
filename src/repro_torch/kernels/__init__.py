"""Hand-written CUDA kernels (``csrc/``), their plain-torch twins and the
wrappers that pick one by the tensors' device."""
