"""Selective-scan golden models, the plain folded forward, and the CUDA
kernel's wrapper and build."""
