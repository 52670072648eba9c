"""Plain PyTorch ops of the port."""
