'''
zephyr_tpu_torch: the PyTorch + CUDA port of zephyr_tpu, for one NVIDIA
Hopper GPU (H100).

The layout mirrors zephyr_tpu, so each module's counterpart is found at
the same path:

- zephyr_tpu_torch.core     — declarative configuration (numpy)
- zephyr_tpu_torch.ops      — coefficient-plane builders, stencil algebra
                              and its torch twins, the CUDA kernel loader
- zephyr_tpu_torch.solver   — multigrid, stratified PCR, BiCGStab and the
                              hybrid Helmholtz solve, differentiable
- zephyr_tpu_torch.backend  — forward modelling (MiniZephyr, its 2.5D
                              ky sum MiniZephyr25D, Eurus, sources, the
                              analytical oracle, grid interpolation, the
                              MultiFreq distributors)
- zephyr_tpu_torch.parallel — multi-frequency modelling on one device:
                              per-frequency operators and solves, the
                              differentiable forward map and misfit, the
                              chunked and 2.5D forward modelling, the
                              chunked adjoint-state FWI gradient
- zephyr_tpu_torch.middleware — the 2D and 2.5D inverse problems:
                              surveys, problems with exact Jvec/Jtvec,
                              the inversion drivers (frequency
                              continuation), the host-side I/O helpers
- zephyr_tpu_torch.frontend — the job classes (OmegaJob and the rest)
                              and the ``zephyr-tpu-torch`` CLI
                              (argparse; ``--device``, default cuda)
- zephyr_tpu_torch.convert  — the JAX package's prepared state into the
                              port's
- zephyr_tpu_torch/csrc     — the CUDA C++ kernels K1-K9 (sm_90a), one
                              for each TPU kernel of zephyr_tpu

The port imports torch, numpy and scipy, never jax.
'''

__version__ = '0.1.0'
