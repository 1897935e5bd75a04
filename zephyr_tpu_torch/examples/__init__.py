'''
zephyr_tpu_torch examples: the JAX package's ``examples/*.py`` on the
port, each runnable as ``python -m zephyr_tpu_torch.examples.<name>``
with ``--device`` (default cuda; ``--device cpu`` runs on the CPU in
complex128).
'''
