"""The point-major MVX-Net detector in PyTorch modules."""
