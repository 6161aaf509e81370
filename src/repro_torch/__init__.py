"""PyTorch + CUDA port of the Dalek serving stack for NVIDIA Hopper.

Mirrors ``repro``'s module layout so each counterpart sits at the same
path. Imports ``torch``, numpy and the standard library only; the JAX
package is the reference it is tested against, never a dependency.
"""
