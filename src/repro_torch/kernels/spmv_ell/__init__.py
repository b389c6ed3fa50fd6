"""ELL SpMV and its transpose: CUDA kernels (``csrc/spmv_ell.cu``),
plain-torch twins (``ref``) and wrappers (``ops``)."""
