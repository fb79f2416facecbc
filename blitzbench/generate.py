"""The one traffic generator: it reads a mix's parameters (a file under
``blitzbench/traffic/``) and the run's ``--seed``, and gives the program
nothing but the requests it makes.

``sessions``: the long cell's fixed set of sessions.  The context lengths
are drawn once, uniformly between the mix's bounds, from the mix's
``set_seed``, and sit in the same slots for every seed, so that a seed
changes the values a run serves and never the shape of its work (the decode
kernel's time depends on which slot holds which length).  ``--seed`` draws
one first token a session.
"""

from __future__ import annotations

import numpy as np


def sessions(mix: dict, seed: int, vocab: int) -> tuple[np.ndarray, np.ndarray]:
    """(context lengths, first tokens) of the mix's sessions, slot by slot."""
    c = mix["context"]
    lengths = np.random.default_rng(mix["set_seed"]).integers(c["lo"], c["hi"] + 1,
                                                              mix["sessions"])
    run = np.random.default_rng([int(seed) % 2**64, 12])
    return lengths, run.integers(0, vocab, mix["sessions"])
