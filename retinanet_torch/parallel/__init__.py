"""Data parallelism over processes (counterpart of
`retinanet_tpu/parallel/`)."""
