"""The coarsening's label joins, one launch each: CUDA kernels
(``csrc/joins.cu``), plain-torch twins (``ref``) and wrappers (``ops``)."""
