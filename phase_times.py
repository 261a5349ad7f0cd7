"""Run some of ``chip_smoke.py``'s phases on the card, each printed line
stamped with the seconds since the start: where a phase's time goes.

    python3 phase_times.py phase16 phase19 phase24

builds the kernels (phase 0) first, then runs the named phases in order
(each takes the card's line where its signature asks for it) and prints
each one's wall time.  A line is cut to 160 characters.
"""

import sys
import time

import torch

import chip_smoke as c

T0 = time.perf_counter()
_say = c.say


def say(*parts):
    _say(f"[{time.perf_counter() - T0:7.1f}]", str(parts[0])[:160])


if __name__ == "__main__":
    if not torch.cuda.is_available():
        c.fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = c.card_line()
    c.say = say
    say(f"card: {card}")
    c.phase0()
    for name in sys.argv[1:]:
        t = time.perf_counter()
        f = getattr(c, name)
        f(card) if f.__code__.co_argcount else f()
        say(f"== {name} {time.perf_counter() - t:.1f} s")
