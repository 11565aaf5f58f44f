"""The plain reference that decides ``correct``: NeuS2's field, step and
renderer in plain PyTorch and numpy, written from the published method
and the configuration file alone.  Nothing here imports the program under
test (``neus2_tpu_torch``) or the JAX package; ``test_portbench_isolation``
checks that."""
