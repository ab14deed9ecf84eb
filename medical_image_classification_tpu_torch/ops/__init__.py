"""Functional ops: the SS2D scan core."""
