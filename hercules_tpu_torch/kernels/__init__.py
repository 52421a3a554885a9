"""Hand-written CUDA kernels for Hopper (``../csrc``) with their ctypes
wrappers and plain PyTorch versions.  Nothing is compiled or loaded
until a wrapper first runs on a CUDA tensor."""
