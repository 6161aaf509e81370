"""Parallelism: logical-axis sharding specs, the int8 compressed reduction
over the slow ``pod`` axis, and autograd-aware collectives."""
