"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Every wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel (or raises) for tensors on the card; each keeps a
``launches`` count.  Nothing is compiled at import: ``build.load`` builds a
library with ``nvcc`` the first time a launch needs it.
"""
