"""The traffic generator, pinned: one ``--seed`` gives the same sessions,
another seed the same context lengths in the same slots with other first
tokens, and every length stays in its bounds with room to decode through a
window."""

import json
from pathlib import Path

import numpy as np
import pytest

from blitzbench import generate

LONG = json.loads((Path(__file__).resolve().parents[1] / "traffic" / "long32k.json").read_text())
SEEDS = (1, 2**31 + 77, 4_000_000_123)


@pytest.mark.parametrize("seed", SEEDS)
def test_one_seed_gives_the_same_sessions(seed):
    la, fa = generate.sessions(LONG, seed, 49152)
    lb, fb = generate.sessions(LONG, seed, 49152)
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(fa, fb)


@pytest.mark.parametrize("seed", SEEDS)
def test_seeds_share_the_lengths_slot_by_slot(seed):
    la, fa = generate.sessions(LONG, seed, 49152)
    lb, fb = generate.sessions(LONG, seed + 1, 49152)
    np.testing.assert_array_equal(la, lb)
    assert not np.array_equal(fa, fb)
    assert fa.min() >= 0 and fa.max() < 49152


def test_lengths_stay_in_their_bounds():
    lengths, _ = generate.sessions(LONG, 5, 49152)
    lo, hi = LONG["context"]["lo"], LONG["context"]["hi"]
    assert len(lengths) == LONG["sessions"] == 16
    assert lengths.min() >= lo and lengths.max() <= hi
    assert len(set(lengths.tolist())) == 16
    assert LONG["max_seq"] >= hi + 2048  # room to decode through a 51 s window
