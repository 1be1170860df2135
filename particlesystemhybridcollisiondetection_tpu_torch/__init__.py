"""PyTorch + CUDA port of the particle system.

Same layout as the JAX package ``particlesystemhybridcollisiondetection_tpu``
(the reference it is checked against), with planar ``[3, N]`` float32
tensors and ``NamedTuple``s of tensors in place of JAX pytrees.  The
three TPU kernels (two on the sorted spatial path, one on the
particle-particle path) are hand-written CUDA for Hopper (``ops/cuda``).  Entry points take ``device=`` and default to ``"cuda"``;
they raise when CUDA is absent unless the caller asks for ``"cpu"``.
This package never imports JAX or the JAX package.
"""
