"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version (``ref.py``), its wrapper (``ops.py``) and its CUDA source
(``csrc/``).  Nothing here imports a kernel library or builds anything at
import time: a kernel is compiled the first time its wrapper meets a CUDA
tensor."""
