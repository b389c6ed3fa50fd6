"""The fused MIS-2 round passes over padded ELL: CUDA kernels
(``csrc/minprop_ell.cu``), plain-torch twins (``ref``) and wrappers
(``ops``)."""
