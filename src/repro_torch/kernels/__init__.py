"""Hopper kernels of the port, each as a kernel/ref/ops triple."""
