"""PyTorch + CUDA port of the medical-image-classification framework.

Runs beside the JAX package ``medical_image_classification_tpu``, which stays
the reference: every ported module sits at the path of its JAX counterpart
and is held against it by the ``tests/test_torch_*.py`` suite.  Plain tensor
work is PyTorch; each Pallas TPU kernel on a ported path becomes a kernel
written by hand for Hopper (``csrc/``), with a plain PyTorch version beside
it that CPU tensors take.

This package imports ``torch`` and numpy, and never JAX.  The only import
from the JAX package is its numpy/C++ ``data`` pipeline.
"""

__version__ = "0.1.0"
