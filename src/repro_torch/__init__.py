"""PyTorch / CUDA port of the ``repro`` model stack for an NVIDIA H100.

The JAX package ``repro`` is the reference and this package imports
nothing of it.  Entry points run on ``cuda`` unless the caller asks for
``device="cpu"``; asked for ``cuda`` without a card, they raise.
"""
