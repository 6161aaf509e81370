"""STREAM suite (paper Sec. 5.1): the CUDA kernels' wrappers (``stream``),
their plain PyTorch versions (``ref``) and the counted entry points with
bytes-moved accounting (``ops``)."""
