"""Process-global amp bookkeeping (counterpart of
:mod:`apex_tpu.amp._amp_state`): the verbosity that :func:`maybe_print`
consults and the last handle ``amp.initialize`` returned, which backs the
module-level ``amp.scale_loss``/``state_dict``/``load_state_dict``.

The JAX package's ``ingraph_logging`` knob is left out. It chooses
whether the overflow line is printed from inside the jitted step through
a host callback, which some TPU runtimes refuse. The port decides
overflow on the host already (one read a step), so the line is always
printed there.
"""

from __future__ import annotations


class AmpState:
    def __init__(self):
        self.verbosity = 1
        self.handle = None


_amp_state = AmpState()


def set_verbosity(v: int):
    _amp_state.verbosity = v


def maybe_print(msg: str):
    # stdout, like the reference's plain print(): downstream scripts grep
    # training output for the overflow line
    if _amp_state.verbosity >= 1:
        print(msg, flush=True)
