"""xorshift64* priorities packed with their ids: CUDA kernel
(``csrc/hash_pack.cu``), plain-torch twin (``ref``) and wrapper (``ops``)."""
