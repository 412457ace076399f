"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): the
harness, its configurations, traffic mixes, metric readers, work
arithmetic and plain references. It imports neither JAX nor the JAX
package the port was made from."""
