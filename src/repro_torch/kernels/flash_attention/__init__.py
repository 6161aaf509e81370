"""Flash attention: the CUDA kernel's wrapper (``ops``) and its plain
PyTorch version (``ref``)."""
