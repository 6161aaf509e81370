"""Dot-product-accumulate matmul (paper Sec. 5.2): the CUDA kernel's wrapper
(``dpa_matmul``), its plain PyTorch version (``ref``) and the counted entry
points with the int8 quantized linear (``ops``)."""
