"""The plain PyTorch reference; imports nothing of the port."""
