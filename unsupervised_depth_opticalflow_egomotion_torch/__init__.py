"""PyTorch/CUDA port of the joint depth / optical-flow / ego-motion trainer.

Mirrors ``unsupervised_depth_opticalflow_egomotion_tpu`` module by module
(config/, models/, ops/, parallel/, utils/) and imports nothing of it. The
hot gathers run as hand-written CUDA kernels for Hopper (csrc/), built with
nvcc at first use; on CPU tensors every kernel wrapper runs its plain
PyTorch version instead. Entry points default to ``device="cuda"``.
"""
