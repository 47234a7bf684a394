"""Plain PyTorch references of the benchmark's configurations.

Written from the published layer equations and the configuration files'
sizes, in float32 with TF32 off. They import neither JAX nor either package
of the repository, and take only the weights and inputs the benchmark draws.
"""
