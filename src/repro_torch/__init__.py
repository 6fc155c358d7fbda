"""PyTorch + CUDA port of the Covenant reproduction, for an NVIDIA H100.

The JAX package ``repro`` is the reference and stays as it is; this package
imports nothing of it.  Its main path: the Covenant Algorithm-1 tiler, run
against the ``h100`` covenant (``targets``), picks the block geometry of
hand-written Hopper kernels (``kernels``), and the dense transformer
(``models``) serves through them (``launch.serve``) and trains through them
(``launch.train``: ``data``, ``optim``, ``runtime``, ``checkpoint``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
