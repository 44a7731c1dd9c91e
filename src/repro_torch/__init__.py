"""PyTorch + CUDA port of the SparseServe reproduction.

The reference implementation is the JAX package ``repro`` beside this one;
every module here mirrors its counterpart there (``configs/``, ``models/``,
``core/``, ``kernels/``, ``serving/``, ``obs/``, ``launch/``) and imports
nothing of it.  The decode kernels are hand-written CUDA C++ for Hopper
(``csrc/``), built at first use (``kernels/build.py``).
"""
