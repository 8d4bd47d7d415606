"""apex_tpu_torch: the PyTorch + CUDA port of :mod:`apex_tpu` for NVIDIA
Hopper (H100).

The package mirrors ``apex_tpu``'s layout and public names for the parts
ported so far (the GPT serving path: paged attention, the dequant-GEMM,
the GPT serving forward, the paged KV cache, sampling and the
continuous-batching engine). Plain tensor code is PyTorch; every Pallas
kernel on a ported path is a CUDA C++ kernel under ``csrc/``, built with
``nvcc`` at first use (:mod:`apex_tpu_torch._build`). Entry points run
on the CUDA card unless the caller passes ``device="cpu"``; a wrapper
takes its plain PyTorch version only for tensors on the CPU.

The port imports neither ``jax`` nor anything of ``apex_tpu``.
"""

__version__ = "0.1.0"
