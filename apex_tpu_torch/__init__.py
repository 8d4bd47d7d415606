"""apex_tpu_torch: the PyTorch + CUDA port of :mod:`apex_tpu` for NVIDIA
Hopper (H100).

The package mirrors ``apex_tpu``'s layout and public names for the parts
ported so far: the GPT serving path (paged attention, the dequant-GEMM,
the GPT serving forward, the paged KV cache, sampling and the
continuous-batching engine), the BERT pretraining step (the fused
LayerNorm backward, fused dropout, bsh flash attention, BERT, amp
O0/O2/O3 with the dynamic loss scaler, FusedLAMB), and BERT training
below ``flash_min_seq`` through ``build_train_step`` and ``TrainLoop``
(the fused scale-mask softmax, FusedScaleMaskSoftmax, gradient
accumulation on one device), GPT training at S 1024 through the same
entry point (``flash_attention`` / ``flash_attention_with_lse`` and the
tiled flash kernels, the GPT training forward and ``lm_loss``, FusedAdam)
and the contrib ``multihead_attn`` modules, and data parallelism over
``torch.distributed`` (``parallel/``: DDP, SyncBatchNorm, LARC, the
bootstrap; ``build_train_step(ddp=)``) with the ResNet tier (contrib
``groupbn``, ``cudnn_gbn``, ``bottleneck``; ``models/resnet.py``), and
the serving engine's host-RAM spill tier, faults and recovery, and the
observability layer (``observability/``: tracer, flight recorder,
metrics). Plain tensor code is
PyTorch; every Pallas kernel on a ported path is a CUDA C++ kernel under
``csrc/``, built with ``nvcc`` at first use
(:mod:`apex_tpu_torch._build`). Entry points run on the CUDA card unless
the caller passes ``device="cpu"``; a wrapper takes its plain PyTorch
version only for tensors on the CPU.

The port imports neither ``jax`` nor anything of ``apex_tpu``.
"""

__version__ = "0.1.0"

from apex_tpu_torch import observability  # noqa: F401
