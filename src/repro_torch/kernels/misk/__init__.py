"""The distance-k MIS fixed point in one launch: CUDA kernel
(``csrc/misk.cu``), plain-torch twins (``ref``) and wrapper (``ops``)."""
