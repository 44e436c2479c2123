"""RetinaNet in PyTorch for one NVIDIA H100: a port of `retinanet_tpu`.

The JAX package stays the reference; this package imports nothing of it.
"""
