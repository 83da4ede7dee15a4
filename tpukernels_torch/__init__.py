"""tpukernels_torch — the PyTorch/CUDA port of ``tpukernels`` for one
NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package ``tpukernels`` is the reference this port is held
against; the port imports nothing from it (and never ``jax``). Module
names follow the reference so each counterpart is easy to find:

- ``tpukernels_torch.kernels``   — wrappers around hand-written CUDA
  kernels (``csrc/``), each beside its plain PyTorch version, plus the
  table of the reference's TPU kernels and their port status
- ``tpukernels_torch.registry``  — name -> wrapper, ``dispatch``
- ``tpukernels_torch.interop``   — numpy operands <-> port tensors
- ``tpukernels_torch.resilience.integrity`` — canary operands,
  tolerances and oracles
- ``tpukernels_torch.tuning``    — ``TPKT_*`` knob resolution
- ``tpukernels_torch._build``    — ``nvcc`` build of ``csrc/`` on first
  use, loaded with ``ctypes``
- ``tpukernels_torch.capi``      — the C entry the port's shim imports
- ``tpukernels_torch.serve``     — the serving daemon
  (``python -m tpukernels_torch.serve``) and its client, on the
  reference's wire
- ``tpukernels_torch.aot``       — the compile discipline (keys, the
  manifest, the dispatch memo, precompile) and the avatar table;
  ``python -m tpukernels_torch.prewarm`` drives it

Importing the package is lazy: it imports no submodule and builds no
kernel. A kernel is compiled the first time its wrapper is called on a
CUDA tensor (or when ``_build.build()`` is called).
"""
