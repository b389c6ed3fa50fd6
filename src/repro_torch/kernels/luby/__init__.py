"""The Luby coloring's round loop in one launch: CUDA kernel
(``csrc/luby.cu``), plain-torch twin (``ref``) and wrapper (``ops``)."""
