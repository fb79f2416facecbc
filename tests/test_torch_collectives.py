"""The port's multicast collectives (``repro_torch.core.collectives``) on 8
CPU processes with the gloo backend, mirroring tests/test_collectives.py
(8 forced host devices there).

Each check starts 8 processes that join one ``torch.distributed`` group over
``tcp://127.0.0.1`` and run the collective; every process must exit 0 within
the timeout.  The NCCL path needs two cards and is not exercised here.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.core import collectives as jax_coll  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
WORLD = 8

WORKER = textwrap.dedent("""
    import sys

    import torch
    import torch.distributed as dist

    from repro_torch.core import collectives as coll

    rank, world, port, what = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    if what == "chain":
        want = torch.arange(1000, dtype=torch.float32)
        for n_blocks in (4, 3, 16):  # 3: padded to 1002 and sliced back
            mine = want.clone() if rank == 0 else torch.full((1000,), -1.0)
            out = coll.chain_broadcast(mine, n_blocks=n_blocks)
            assert torch.equal(out, want), (rank, n_blocks)
        # a chain that starts at rank 2: ranks 0, 1 keep their blocks
        blocks = torch.full((5, 7), float(rank))
        out = coll.chain_broadcast_blocks(blocks, src=2)
        assert torch.equal(out, torch.full((5, 7), 2.0 if rank >= 2 else float(rank))), rank
    elif what == "sharded":
        layout = [[0, 1, 2, 3], [4, 5, 6, 7]]  # 2 chain positions x 4 scale-up ranks
        groups = coll.scaleup_groups(layout)
        full = torch.arange(64, dtype=torch.float32)
        c, u = divmod(rank, 4)
        shard = full[16 * u:16 * (u + 1)].clone() if c == 0 else torch.full((16,), -5.0)
        out = coll.sharded_group_transfer(shard, layout, groups, src=0, dst=1)
        assert out.shape == (64,)
        if c == 1:
            assert torch.equal(out, full), rank
        else:
            assert torch.equal(out, torch.zeros(64)), rank  # received nothing
    else:
        raise SystemExit(f"unknown check {what}")
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(what: str) -> None:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(WORLD), port, what],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * WORLD, "\n".join(o[-2000:] for o in outs)


def test_chain_broadcast_delivers_to_all_ranks():
    """1000 elements over 8 ranks in 4 blocks (and 3, padded; and 16): every
    rank ends with the vector rank 0 injected; a chain from rank 2 on."""
    _run("chain")


def test_sharded_group_transfer_allgather():
    """2 x 4 layout: each rank of domain 0 ships its 16-element shard to its
    peer in domain 1, which all-gathers the full 64 elements."""
    _run("sharded")


@pytest.mark.parametrize("n_blocks,n_ranks", [(16, 8), (16, 2), (64, 8), (1, 1), (4, 3)])
def test_chain_formulas_equal_jax(n_blocks, n_ranks):
    """The copied arithmetic equals the JAX package's, and the step count is
    the pipelined n_blocks + n_ranks - 2 (Fig. 13a)."""
    assert coll.pipelined_chain_steps(n_blocks, n_ranks) == jax_coll.pipelined_chain_steps(n_blocks, n_ranks)
    assert coll.chain_broadcast_seconds(16e9, 12.5e9, n_blocks, n_ranks) == \
        jax_coll.chain_broadcast_seconds(16e9, 12.5e9, n_blocks, n_ranks)
    if n_ranks >= 2:
        assert coll.pipelined_chain_steps(n_blocks, n_ranks) == n_blocks + n_ranks - 2


def test_chain_broadcast_seconds_independent_of_ranks():
    t2 = coll.chain_broadcast_seconds(16e9, 12.5e9, n_blocks=64, n_ranks=2)
    t8 = coll.chain_broadcast_seconds(16e9, 12.5e9, n_blocks=64, n_ranks=8)
    assert t8 / t2 < 1.15
