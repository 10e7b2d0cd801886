"""antmmf_torch: the PyTorch and CUDA port of antmmf_tpu for NVIDIA Hopper.

The package mirrors ``antmmf_tpu``'s layout and names and imports nothing of
it, nor of JAX. Its kernels are hand-written CUDA (``ops/csrc``), built with
``nvcc`` at first use. Entry points run on CUDA unless the caller asks for
the CPU.
"""
