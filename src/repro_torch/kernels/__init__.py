"""Hand-written Hopper kernels of the port, one directory each: the
kernel's source and its wrapper, an ``ops.py`` dispatcher and a
``ref.py`` plain PyTorch version of the same function."""
