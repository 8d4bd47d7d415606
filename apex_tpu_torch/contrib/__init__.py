"""Contrib tier (counterpart of :mod:`apex_tpu.contrib`): opt-in
subpackages, imported explicitly (``apex_tpu_torch.contrib.multihead_attn``).
Ported so far: ``multihead_attn``, ``openfold``, ``groupbn``,
``cudnn_gbn`` and ``bottleneck`` (its ``Bottleneck``)."""
