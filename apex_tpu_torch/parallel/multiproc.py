"""Deprecated per-device process launcher (counterpart of
:mod:`apex_tpu.parallel.multiproc`, a parity shim): it only points at the
launcher that replaced the reference's, ``torchrun``."""

import sys


def main():
    sys.stderr.write(
        "apex_tpu_torch.parallel.multiproc is deprecated (as its reference "
        "was). Launch one process per GPU with torchrun "
        "(torchrun --nproc_per_node=N train.py) and call "
        "apex_tpu_torch.parallel.init_process_group().\n")
    raise SystemExit(1)


if __name__ == "__main__":
    main()
