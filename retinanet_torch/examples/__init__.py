"""Example scripts of the port: `python -m retinanet_torch.examples.<name>`."""
