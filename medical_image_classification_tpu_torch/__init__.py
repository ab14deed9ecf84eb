"""PyTorch + CUDA port of the medical-image-classification framework.

Runs beside the JAX package ``medical_image_classification_tpu``, which stays
the reference: every ported module sits at the path of its JAX counterpart
and is held against it by the ``tests/test_torch_*.py`` suite.  Plain tensor
work is PyTorch; each Pallas TPU kernel on a ported path becomes a kernel
written by hand for Hopper (``csrc/``), with a plain PyTorch version beside
it that CPU tensors take.

This package imports ``torch``, numpy and OpenCV, and never JAX nor any
module of the JAX package: where it needs one, it keeps its own copy.
"""

__version__ = "0.1.0"
