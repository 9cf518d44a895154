"""Device layer: lane-parallel token decode (CUDA kernel + plain PyTorch
version) and successor reconstruction."""
