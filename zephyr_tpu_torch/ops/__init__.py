'''
zephyr_tpu_torch ops: coefficient-plane builders, stencil algebra with
its torch twins and kernel dispatch, the CUDA kernel loader, Kaiser
injection/extraction and special functions.
'''
