"""Ordered run sums of a sorted key stream: CUDA kernel
(``csrc/run_sums.cu``), plain-torch twin (``ref``) and wrapper (``ops``)."""
