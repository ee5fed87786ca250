"""Plain PyTorch references of the benchmark's configurations: float32
step loops and products, no kernel, no cache, nothing of the port."""
