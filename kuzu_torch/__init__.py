"""PyTorch/CUDA port of kuzu for NVIDIA Hopper (see README, "PyTorch port")."""
