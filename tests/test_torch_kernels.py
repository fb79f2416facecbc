"""The port's kernels: plain versions against the JAX Pallas kernels, and (on
a card) the CUDA kernels against their plain versions.

On the CPU ``ops.*`` take the plain versions (``repro_torch.kernels.ref``);
they are held against the Pallas kernels run with ``interpret=True`` at a
subset of tests/test_kernels.py's shapes.  The ``cuda``-marked tests run the
hand-written kernels on the card and skip elsewhere.  Tolerances are the
reference's own: f32 3e-5, bf16 2e-2.

JAX is imported only by the tests that need it, so that the ``cuda`` tests
also run on a machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels.decode_attention import decode_plan  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": dict(atol=3e-5, rtol=3e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}

FLASH_SHAPES = [  # b, sq, sk, h, kv, d
    (2, 64, 64, 4, 2, 32),  # GQA 2:1
    (1, 48, 32, 6, 3, 128),  # uneven blocks, D 128
    (1, 80, 80, 5, 5, 96),  # MLA at minicpm3's qk dim, lengths not block multiples
    (2, 40, 40, 4, 4, 24),  # MLA at REDUCED minicpm3's qk dim
    (1, 40, 40, 12, 1, 192),  # nemotron's head dim at n_rep 12
    (2, 24, 60, 4, 4, 64),  # whisper's cross-attention: Sq != Sk at D = 64
]
# MLA's qk head dims -> v_head_dim (configs/minicpm3_4b.py, full and REDUCED):
# at these D, V is zero-padded from v_head_dim and the scale passed
# explicitly, as mla_prefill calls the kernel
MLA_V_DIMS = {96: 64, 24: 16}
DECODE_SHAPES = [(2, 128, 8, 2, 32), (2, 96, 8, 1, 128)]  # b, s, h, kv, d
# the n_rep of nemotron REDUCED (3), grok-1 (6) and nemotron (12), and
# nemotron's head dim 192
NEW_DECODE_SHAPES = [(2, 64, 6, 2, 16), (2, 80, 12, 2, 128), (2, 48, 24, 2, 192)]
RMS_SHAPES = [(4, 7, 64), (130, 256)]


def _inputs(seed, shapes, dt, device="cpu"):
    """(numpy f32 arrays, the same as torch tensors of dtype ``dt``)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return arrs, [torch.from_numpy(a).to(device=device, dtype=DTYPES[dt]) for a in arrs]


def _close(got, want, dt):
    want = want.float().cpu().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    np.testing.assert_allclose(got.float().cpu().numpy(), want, **TOL[dt])


@pytest.fixture(scope="module")
def pallas():
    """The JAX Pallas kernels (run in interpret mode) and a converter of numpy
    inputs to JAX arrays of a given dtype; the results come back as f32 numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.decode_attention import decode_attention
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.rmsnorm import fused_rmsnorm

    def run(fn, arrs, dt, *args, **kw):
        jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt]
        out = fn(*[jnp.asarray(a, dtype=jd) for a in arrs], *args, interpret=True, **kw)
        return np.asarray(out.astype(jnp.float32))

    return types.SimpleNamespace(
        jnp=jnp, run=run, rmsnorm=fused_rmsnorm, flash=flash_attention, decode=decode_attention
    )


def _lengths(seed, b, s):
    return np.random.default_rng(seed).integers(1, s + 1, size=b).astype(np.int32)


# ---------------------------------------------------------------------------
# Plain versions (CPU) against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_plain_matches_pallas(pallas, shape, dt):
    arrs, (xt, wt) = _inputs(0, [shape, shape[-1:]], dt)
    want = pallas.run(pallas.rmsnorm, arrs, dt, block_n=16)
    _close(ops.rmsnorm(xt, wt), want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,h,kv,d", FLASH_SHAPES)
def test_flash_plain_matches_pallas(pallas, b, sq, sk, h, kv, d, causal, dt):
    arrs, (qt, kt, vt) = _inputs(1, [(b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)], dt)
    kw = {}
    if d in MLA_V_DIMS:
        arrs[2][..., MLA_V_DIMS[d]:] = 0.0
        vt = torch.from_numpy(arrs[2]).to(DTYPES[dt])
        kw["softmax_scale"] = 1.0 / np.sqrt(d)
    want = pallas.run(pallas.flash, arrs, dt, causal=causal, block_q=32, block_k=32, **kw)
    got = ops.flash_attention(qt, kt, vt, causal=causal, **kw)
    _close(got, want, dt)
    if d in MLA_V_DIMS:  # zero V columns give zero output columns
        assert float(got[..., MLA_V_DIMS[d]:].abs().max()) == 0.0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kv,d", DECODE_SHAPES + NEW_DECODE_SHAPES)
def test_decode_plain_matches_pallas(pallas, b, s, h, kv, d, dt):
    arrs, (qt, kt, vt) = _inputs(2, [(b, h, d), (b, kv, s, d), (b, kv, s, d)], dt)
    lens = _lengths(3, b, s)

    def decode(q, k, v, **kw):
        return pallas.decode(q, k, v, pallas.jnp.asarray(lens), **kw)

    want = pallas.run(decode, arrs, dt, block_s=32)
    _close(ops.decode_attention(qt, kt, vt, torch.from_numpy(lens)), want, dt)


def test_ops_auto_on_cpu_is_the_plain_version():
    _, (q, k, v) = _inputs(4, [(1, 16, 4, 8), (1, 16, 2, 8), (1, 16, 2, 8)], "f32")
    assert torch.equal(
        ops.flash_attention(q, k, v), ops.flash_attention(q, k, v, impl="ref")
    )
    with ops.use_impl("ref"):
        assert torch.equal(ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v))


def test_launch_counts_reset():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "decode_attention": 0,
                                   "rmsnorm_bwd": 0, "flash_attention_bwd": 0}


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("d", [16, 128, 80])
@pytest.mark.parametrize(
    "b,kv,s", [(1, 1, 1), (1, 2, 4096), (2, 2, 64), (3, 8, 1000), (4, 8, 1024), (64, 8, 1024), (2, 8, 96)]
)
def test_decode_plan_partitions_the_cache(b, kv, s, d, elem):
    """The cluster divides the grid's x dimension, the chunks cover S, and
    every row below the length is read by exactly one CTA of the cluster."""
    plan = decode_plan(b, kv, s, d, elem)
    assert 1 <= plan.cluster <= 8
    assert plan.grid == (plan.cluster, kv, b) and plan.grid[0] % plan.cluster == 0
    assert plan.cluster * plan.chunks_per_cta * plan.chunk >= s
    assert (plan.cluster * plan.chunks_per_cta - 1) * plan.chunk < s  # no chunk slot wholly past S
    assert 4 * plan.chunk * d * elem <= 64 * 1024 or plan.chunk == 16  # the 2-stage ring fits
    for length in sorted({min(n, s) for n in (0, 1, plan.chunk + 1, s // 2, s)}):
        rows = [r for rank in range(plan.cluster) for r in plan.rows_of(rank, length)]
        assert sorted(rows) == list(range(length))
        assert all(len(plan.rows_of(rank, length)) <= plan.chunks_per_cta * plan.chunk
                   for rank in range(plan.cluster))


@pytest.mark.parametrize("n_rep,groups", [(1, 1), (3, 1), (6, 1), (8, 1), (12, 2), (32, 4)])
@pytest.mark.parametrize("b,kv,s,d,elem", [
    (4, 8, 552, 192, 2), (4, 8, 552, 192, 4), (3, 8, 1000, 192, 4), (1, 2, 4096, 192, 2),
    (1, 1, 1, 192, 4), (4, 8, 552, 128, 2), (4, 20, 1500, 64, 2), (1, 1, 100, 16, 4)])
def test_decode_plan_splits_the_heads_into_groups(n_rep, groups, b, kv, s, d, elem):
    """n_rep above 8 (nemotron's 12; 32 q heads over one KV head) splits
    into equal groups of at most 8 heads, each group a cluster of its own (grid y = KV x groups) over the
    same chunks; at D = 192 a chunk is at most 32 rows in bf16 and 16 in f32
    (the 2-stage ring of K and V chunks fits 64 KB); the chunks cover S,
    rank 0 needs every chunk slot a CTA is given, and every row below the
    length is read by exactly one CTA of each group's cluster."""
    plan = decode_plan(b, kv, s, d, elem, n_rep)
    assert plan.groups == groups and (n_rep // groups) <= 8 and n_rep % groups == 0
    assert 1 <= plan.cluster <= 8 and plan.grid == (plan.cluster, kv * groups, b)
    assert 4 * plan.chunk * d * elem <= 64 * 1024 or plan.chunk == 16
    if d == 192:
        assert plan.chunk <= {2: 32, 4: 16}[elem]
    assert plan.cluster * plan.chunks_per_cta * plan.chunk >= s
    assert plan.cluster * (plan.chunks_per_cta - 1) * plan.chunk < s
    for length in sorted({min(n, s) for n in (0, 1, plan.chunk + 1, s // 3, s)}):
        rows = [r for rank in range(plan.cluster) for r in plan.rows_of(rank, length)]
        assert sorted(rows) == list(range(length))


INT8_PLAN_SHAPES = [  # b, kv, s: 8 and 16 x 32k, serving, served S, whisper's cross cache, tiny
    (8, 8, 32768), (16, 8, 32768), (4, 8, 1024), (4, 8, 552), (4, 20, 1500), (5, 2, 600),
    (1, 1, 1), (2, 1, 15), (3, 2, 17), (1, 1, 100)]


@pytest.mark.parametrize("n_rep", dk.N_REPS)
@pytest.mark.parametrize("d", dk.HEAD_DIMS)
def test_decode_plan_int8(d, n_rep):
    """The int8 cache's plans, under a bf16 q (the tensor-core route) and an
    f32 q (the CUDA-core loop), at every head dim and n_rep: chunks of a
    multiple of 16 rows (the tensor-core route's tiles, a masked tail), a
    CTA's shared memory within the 232,448 bytes a block may use; on the
    tensor-core route a ring no deeper than a CTA's chunks, one chunk of at
    most 256 rows a CTA on a short cache, chunks of 64 rows or more on a long
    one within an SM's share for the 4 CTAs an SM its registers allow (3 at
    D = 192, where 64-row chunks need more); and every row below the length
    read once over the cluster's ranks (at S up to 4096: the long caches'
    plans split rows by the same rule)."""
    for mma in (True, False):
        for b, kv, s in INT8_PLAN_SHAPES:
            plan = decode_plan(b, kv, s, d, 1, n_rep, mma=mma)
            assert plan.chunk % 16 == 0 and plan.smem <= dk.SMEM_PER_BLOCK
            assert plan.groups == dk.head_groups(n_rep) and n_rep // plan.groups <= 8
            if mma:
                assert plan.smem == dk.mma_smem(d, plan.chunk, plan.ring)
                assert 1 <= plan.ring <= min(dk.MMA_STAGES, plan.chunks_per_cta)
                if s <= dk.MMA_SHORT_ROWS * dk.MAX_CLUSTER:  # one chunk of <= 256 rows a CTA
                    assert plan.chunks_per_cta == 1 and plan.chunk <= dk.MMA_SHORT_ROWS
                else:  # 64 rows or more, 4 CTAs an SM (3 at D = 192) where more than 64
                    assert plan.chunk >= dk.MMA_MIN_CHUNK
                    if plan.chunk > dk.MMA_MIN_CHUNK or d <= 128:
                        assert dk.MMA_CTAS_PER_SM[d] * (plan.smem + 1024) <= dk.SMEM_PER_SM
            if s > 4096:
                continue
            for length in sorted({min(n, s) for n in (0, 1, 15, 17, plan.chunk - 1, plan.chunk + 1,
                                                       s // 3, s)}):
                rows = [r for rank in range(plan.cluster) for r in plan.rows_of(rank, length)]
                assert sorted(rows) == list(range(length))


# clusters of the tensor-core route an H100 80GB HBM3 holds at once, by
# cluster size, with 4 and with 2 CTAs an SM (cudaOccupancyMaxActiveClusters,
# tools/decode_int8_sweep.py)
H100_CLUSTERS = {4: {8: 62, 7: 69, 6: 79, 5: 94, 4: 124, 3: 163, 2: 264},
                 2: {8: 30, 7: 32, 6: 39, 5: 47, 4: 62, 3: 79, 2: 132}}


def _h100_fit(d, chunk, ring, cluster):
    per_sm = min(dk.SMEM_PER_SM // (dk.mma_smem(d, chunk, ring) + 1024), dk.MMA_CTAS_PER_SM[d])
    return H100_CLUSTERS[4 if per_sm >= 4 else 2][cluster]


@pytest.mark.parametrize("b,cluster", [(8, 7), (16, 7), (4, 8)])
def test_decode_plan_int8_cluster_fills_the_waves(b, cluster):
    """The tensor-core route's cluster size on a long cache, from the
    clusters a card holds at once: granite's 8 x 32k gets 64 clusters of 7
    in one wave where 62 of 8 fit (2 clusters would run alone in a second),
    16 x 32k clusters of 7 in two full waves, and 4 slots (32 clusters)
    clusters of 8 in one; 64-row chunks in a 3-stage ring, 4 CTAs an SM."""
    plan = decode_plan(b, 8, 32768, 128, 1, 4, mma=True, clusters_fit=_h100_fit)
    assert plan.cluster == cluster and plan.grid == (cluster, 8, b)
    assert (plan.chunk, plan.ring) == (64, 3) and plan.cluster * plan.chunks_per_cta * 64 >= 32768


@pytest.mark.parametrize("b,kv,s,d,n_rep,cluster,chunk", [
    (4, 8, 1024, 128, 4, 4, 256), (4, 32, 552, 80, 1, 3, 192), (4, 20, 1500, 64, 1, 6, 256),
    (4, 8, 552, 192, 12, 3, 192), (1, 1, 1, 128, 1, 1, 16), (2, 1, 2048, 16, 32, 8, 256)])
def test_decode_plan_int8_short_cache(b, kv, s, d, n_rep, cluster, chunk):
    """A short cache (at most 2,048 rows) on the tensor-core route: one
    chunk of about 256 rows a CTA (the serving shape's 1,024 rows in 4, the
    served S of 552 in 3 of 192), whatever the card holds at once."""
    plan = decode_plan(b, kv, s, d, 1, n_rep, mma=True, clusters_fit=_h100_fit)
    groups = dk.head_groups(n_rep)
    assert (plan.cluster, plan.chunk, plan.chunks_per_cta, plan.ring) == (cluster, chunk, 1, 1)
    assert plan.grid == (cluster, kv * groups, b) and plan.cluster * plan.chunk >= s


FWD_PLAN_SHAPES = [  # b, sq, h: the serving prefill, olmoe, MLA, whisper's encoder, the train
    # microbatch, ragged and tiny ones
    (1, 512, 32), (1, 512, 16), (1, 512, 40), (1, 1500, 20), (4, 2048, 32), (2, 133, 8), (3, 1, 5),
]


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("d", [16, 24, 32, 64, 80, 96, 128, 192])
@pytest.mark.parametrize("b,sq,h", FWD_PLAN_SHAPES)
def test_flash_fwd_plan(b, sq, h, d, elem):
    """The forward's launch from the shape alone: the CTAs' q-blocks cover
    every query row of every (sequence, head) once, heaviest causal q-block
    first (the f32 kernel over all sequences, the bf16 one sequence by
    sequence); a CTA's shared memory fits 227 KB at every head dim; f32
    takes 64-row q-blocks unless that gives fewer CTAs than SMs, and
    its ring as deep as keeps two CTAs an SM where they fit (every D up to
    64), else as deep as one CTA holds."""
    from repro_torch.kernels import flash_attention as flash

    plan = flash.fwd_plan(b, sq, 777, h, d, elem)
    assert plan == flash.fwd_plan(b, sq, 1, h, d, elem)  # the keys do not move it
    assert plan.smem <= flash.SMEM_CTA and plan.per_sm >= 1
    n64 = -(-sq // 64) * h * b
    if elem == 2:
        assert (plan.block_q, plan.block_k, plan.stages) == (128, 64, 2)
    else:
        assert plan.block_q == (64 if n64 >= flash.SMS else 32)
        assert plan.block_k == (32 if d == 192 else 64) and plan.stages in (2, 3)
        assert plan.per_sm >= 2 if d <= 64 else plan.per_sm == 1
    blocks = list(plan.q_blocks())
    assert len(blocks) == plan.ctas
    seen = np.zeros((b, h, sq), dtype=np.int64)
    for sb, hh, q0 in blocks:
        assert q0 % plan.block_q == 0 and 0 <= q0 < sq
        seen[sb, hh, q0:q0 + plan.block_q] += 1
    assert (seen == 1).all()
    starts = [q0 for _, _, q0 in blocks]
    if elem == 4:
        assert starts == sorted(starts, reverse=True)
    else:
        for sb in range(b):
            mine = [q0 for x, _, q0 in blocks if x == sb]
            assert mine == sorted(mine, reverse=True)


def test_flash_fwd_plan_rejects_other_head_dims():
    from repro_torch.kernels import flash_attention as flash

    with pytest.raises(ValueError, match="head dim"):
        flash.fwd_plan(1, 8, 8, 2, 72, 4)


RMS_PLAN_D = [1, 13, 256, 768, 1001, 1280, 2560, 4096, 18432]


@pytest.mark.parametrize("n", [1, 37, 512, 8192])
@pytest.mark.parametrize("d", RMS_PLAN_D)
@pytest.mark.parametrize("elem,vector", [(2, True), (4, True), (2, False), (4, False)])
def test_rmsnorm_fwd_plan(elem, vector, d, n):
    """The forward's launch from the shape alone: a team of the fewest warps
    holds a row, each lane a power of two of its vectors (or elements) up to
    FWD_NV in registers (the two-pass CTA only for rows wider than
    FWD_TEAM_WARPS warps can hold); CTAs of multiples of 32 threads up to
    the kernel's limits, whole teams each; at most one wave of them (by
    threads and registers on SMS SMs); and the CTAs' row stride covers
    every row once."""
    from repro_torch.kernels import rmsnorm as rms

    vector = vector and d * elem % 16 == 0  # a row that is not whole vectors takes the scalar path
    warps, threads, grid, nv = rms.fwd_plan(n, d, elem, vector)
    assert rms.fwd_plan(n, d, elem, vector) == (warps, threads, grid, nv)
    lanes, most = (d * elem // 16 if vector else d), rms.FWD_NV
    assert threads % 32 == 0 and threads % (32 * warps) == 0
    if nv == 0:
        assert lanes > most * 32 * rms.FWD_TEAM_WARPS and threads == 32 * warps == rms.FWD_STREAM_THREADS
    else:
        assert nv & (nv - 1) == 0 and 1 <= nv <= most and warps <= rms.FWD_TEAM_WARPS and threads <= 512
        assert (nv // 2) * 32 * warps < lanes <= nv * 32 * warps
        assert warps == 1 or lanes > most * 16 * warps  # the fewest warps that hold the row
    per_sm = min(rms.THREADS_SM // threads, rms.REGS_SM // (threads * rms.fwd_regs(nv, vector)))
    assert 1 <= grid <= rms.SMS * max(1, per_sm)  # one wave
    teams = threads // (32 * warps)
    covered = np.zeros(n, dtype=np.int64)
    for cta in range(grid):
        for base in range(cta * teams, n, grid * teams):
            rows = np.arange(base, min(base + teams, n))
            covered[rows] += 1
    assert (covered == 1).all()


def test_rmsnorm_fwd_plan_takes_two_passes_past_the_registers():
    from repro_torch.kernels import rmsnorm as rms

    assert rms.fwd_plan(4, 16384, 4, True)[:2] == (16, 512)  # 4096 f32 vectors: 16 warps of 8
    assert rms.fwd_plan(4, 18432, 2, True)[:2] == (16, 512)  # nemotron's 2304 bf16 vectors
    assert rms.fwd_plan(4, 16388, 4, True) == (32, 1024, 4, 0)
    assert rms.fwd_plan(4, 40000, 2, True)[3] == 0 and rms.fwd_plan(4, 4097, 4, False)[3] == 0


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize(
    "shape", RMS_SHAPES + [(3, 5, 7, 16), (5, 13), (128, 2560), (128, 768)])  # qwen/minicpm3 d, q_norm
def test_rmsnorm_kernel_matches_plain(cuda, shape, dt):
    _, (x, w) = _inputs(5, [shape, shape[-1:]], dt, cuda)
    _close(ops.rmsnorm(x, w, impl="kernel"), ref.rmsnorm_ref(x, w), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "b,sq,sk,h,kv,d",
    FLASH_SHAPES
    + [(1, 100, 100, 8, 8, 64), (2, 128, 256, 4, 1, 16), (1, 300, 300, 32, 8, 128),
       (2, 200, 333, 8, 2, 96), (1, 130, 70, 6, 3, 24),
       (1, 128, 128, 20, 20, 128), (1, 128, 128, 40, 40, 96),  # qwen1.5-4b, minicpm3 (n_rep 1)
       (1, 100, 100, 4, 4, 80), (2, 130, 200, 8, 2, 80), (1, 512, 512, 32, 32, 80),  # zamba2's D = 80
       (1, 200, 200, 12, 1, 192), (2, 130, 70, 24, 2, 192), (1, 300, 300, 96, 8, 192)],  # nemotron
)
def test_flash_kernel_matches_plain(cuda, b, sq, sk, h, kv, d, causal, dt):
    _, (q, k, v) = _inputs(6, [(b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)], dt, cuda)
    got = ops.flash_attention(q, k, v, causal=causal, impl="kernel")
    _close(got, ref.flash_attention_ref(q, k, v, causal=causal), dt)
    got = ops.flash_attention(q, k, v, causal=causal, softmax_scale=0.3, impl="kernel")
    _close(got, ref.flash_attention_ref(q, k, v, causal=causal, softmax_scale=0.3), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize(
    "b,s,h,kv,d",
    DECODE_SHAPES + [(3, 100, 4, 4, 64), (1, 256, 16, 8, 16), (4, 152, 20, 20, 128),  # qwen1.5-4b
                     (3, 100, 4, 4, 80), (2, 300, 16, 2, 80), (4, 1024, 32, 32, 80),  # zamba2's D = 80
                     (4, 552, 16, 16, 128), (4, 552, 32, 32, 80),  # olmoe and zamba2 served
                     # grok-1 (n_rep 6), nemotron (n_rep 12, D = 192), pixtral (n_rep 4)
                     # served, and whisper's cross cache of 1500 frames
                     (4, 552, 48, 8, 128), (4, 552, 96, 8, 192), (4, 552, 32, 8, 128),
                     (4, 1500, 20, 20, 64)])
def test_decode_kernel_matches_plain(cuda, b, s, h, kv, d, dt):
    _, (q, k, v) = _inputs(7, [(b, h, d), (b, kv, s, d), (b, kv, s, d)], dt, cuda)
    lens = torch.from_numpy(_lengths(8, b, s)).to(cuda)
    got = ops.decode_attention(q, k, v, lens, impl="kernel")
    _close(got, ref.decode_attention_ref(q, k, v, lens), dt)


@pytest.mark.cuda
def test_flash_kernel_granite_shape(cuda):
    """bf16 at the serving prefill's shape: B=1, S=512, H=32, KV=8, D=128."""
    _, (q, k, v) = _inputs(10, [(1, 512, 32, 128), (1, 512, 8, 128), (1, 512, 8, 128)], "bf16", cuda)
    got = ops.flash_attention(q, k, v, causal=True, impl="kernel")
    _close(got, ref.flash_attention_ref(q, k, v, causal=True), "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("s,h,d", [(512, 40, 96), (37, 4, 24)], ids=["minicpm3", "reduced"])
def test_flash_kernel_mla_shape(cuda, s, h, d, dt):
    """MLA prefill's call: H = KV (n_rep 1), V zero-padded from v_head_dim to
    the qk dim, scale 1/sqrt(qk dim); D = 24 goes through the wrapper's
    zero padding to 32."""
    _, (q, k, v) = _inputs(14, [(1, s, h, d)] * 3, dt, cuda)
    v[..., MLA_V_DIMS[d]:] = 0
    kw = dict(causal=True, softmax_scale=1.0 / np.sqrt(d))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, impl="kernel", **kw)
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.shape == q.shape
    _close(got, ref.flash_attention_ref(q, k, v, **kw), dt)
    assert float(got[..., MLA_V_DIMS[d]:].abs().max()) == 0.0
    other = torch.zeros(1, 8, 2, 40, device=cuda, dtype=DTYPES[dt])  # no other D is padded
    with pytest.raises(ValueError, match="unsupported shapes"):
        ops.flash_attention(other, other, other, impl="kernel")


def test_flash_head_dims_cover_mla():
    """The kernel takes MLA's qk dims: 96 natively, 24 zero-padded to 32."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash

    assert flash.PADDED_HEAD_DIMS == {24: 32} and flash.PADDED_HEAD_DIMS[24] in flash.HEAD_DIMS
    for reduced in (False, True):
        cfg = get_config("minicpm3-4b", reduced=reduced)
        d = cfg.mla_qk_head_dim
        assert d in flash.HEAD_DIMS or d in flash.PADDED_HEAD_DIMS
        assert MLA_V_DIMS[d] == cfg.v_head_dim


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 128, 64, 192])
def test_flash_kernel_cross_lengths_with_scale(cuda, d, dt):
    """Non-causal, Sq != Sk (ragged on both sides), an explicit scale: the
    bf16 kernel's transposed V operand at the smallest and largest D, and at
    whisper's cross-attention (D = 64) and nemotron's D = 192."""
    _, (q, k, v) = _inputs(11, [(2, 200, 8, d), (2, 333, 2, d), (2, 333, 2, d)], dt, cuda)
    got = ops.flash_attention(q, k, v, causal=False, softmax_scale=0.05, impl="kernel")
    _close(got, ref.flash_attention_ref(q, k, v, causal=False, softmax_scale=0.05), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_kernel_edge_lengths(cuda, dt):
    """Lengths 0, S, 1 and one chunk + 1 in one batch: empty CTAs, a full
    cache, a single row and a ragged second chunk."""
    b, s, h, kv, d = 4, 512, 8, 2, 128
    chunk = decode_plan(b, kv, s, d, 2 if dt == "bf16" else 4).chunk
    _, (q, k, v) = _inputs(12, [(b, h, d), (b, kv, s, d), (b, kv, s, d)], dt, cuda)
    lens = torch.tensor([0, s, 1, chunk + 1], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lens, impl="kernel")
    # A row of length 0 gives 0, as the TPU kernel's acc / max(l, 1e-30)
    # does; the plain oracle (like the reference's) averages V there.
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got[1:], ref.decode_attention_ref(q, k, v, lens)[1:], dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kv,d", [(2, 1000, 16, 2, 128), (1, 4096, 8, 2, 128), (2, 4096, 32, 8, 64)])
def test_decode_kernel_long_and_ragged(cuda, b, s, h, kv, d, dt):
    """n_rep = 8 with S not a multiple of the chunk, and S = 4096, where each
    CTA of the cluster walks several chunks through its 2-stage ring."""
    _, (q, k, v) = _inputs(13, [(b, h, d), (b, kv, s, d), (b, kv, s, d)], dt, cuda)
    lens = torch.tensor([s, s - 37][:b], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lens, impl="kernel")
    _close(got, ref.decode_attention_ref(q, k, v, lens), dt)


@pytest.mark.cuda
def test_decode_kernel_ignores_rows_past_length(cuda):
    _, (q, k, v) = _inputs(9, [(2, 4, 16), (2, 2, 64, 16), (2, 2, 64, 16)], "f32", cuda)
    lens = torch.tensor([10, 20], dtype=torch.int32, device=cuda)
    out1 = ops.decode_attention(q, k, v, lens, impl="kernel")
    past = torch.arange(64, device=cuda)[None, None, :, None] >= lens[:, None, None, None].long()
    out2 = ops.decode_attention(
        q, torch.where(past, 99.0, k), torch.where(past, -99.0, v), lens, impl="kernel"
    )
    torch.testing.assert_close(out1, out2, atol=1e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
def test_decode_kernel_head_dim_80(cuda, n_rep, dt):
    """D = 80 (zamba2): a row is 10 (bf16) or 20 (f32) lanes, so a warp holds
    whole rows and idle lanes.  Lengths 0, S, 1, one chunk + 1 and one not a
    multiple of 16, at every n_rep."""
    b, s, kv, d = 5, 700, 2, 80
    chunk = decode_plan(b, kv, s, d, 2 if dt == "bf16" else 4).chunk
    _, (q, k, v) = _inputs(15, [(b, kv * n_rep, d), (b, kv, s, d), (b, kv, s, d)], dt, cuda)
    lens = torch.tensor([0, s, 1, chunk + 1, 333], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lens, impl="kernel")
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got[1:], ref.decode_attention_ref(q, k, v, lens)[1:], dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 128, 192])
@pytest.mark.parametrize("n_rep", [3, 6, 12, 32])
def test_decode_kernel_new_n_reps(cuda, n_rep, d, dt):
    """n_rep 3 (nemotron REDUCED), 6 (grok-1), 12 (nemotron: two head
    groups of 6 over one cache) and 32 (granite-8b's q heads over one KV
    head: four groups of 8) at D = 16, 128 and 192 (a row of 24 lanes; two
    16-byte vectors a lane in f32).  Lengths 0, S, 1, one chunk + 1 and
    ragged."""
    b, s, kv = 5, 600, 2
    chunk = decode_plan(b, kv, s, d, 2 if dt == "bf16" else 4, n_rep).chunk
    _, (q, k, v) = _inputs(16, [(b, kv * n_rep, d), (b, kv, s, d), (b, kv, s, d)], dt, cuda)
    lens = torch.tensor([0, s, 1, chunk + 1, 333], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lens, impl="kernel")
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got[1:], ref.decode_attention_ref(q, k, v, lens)[1:], dt)


def _int8_cache(seed, b, kv, s, d, device):
    """An int8 cache (b, kv, s, d) and its f32 scales, quantized from normal
    K/V by the cache's own quantize_kv."""
    from repro_torch.models.kvcache import quantize_kv

    _, (k, v) = _inputs(seed, [(b, kv, s, d), (b, kv, s, d)], "f32", device)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return kq, vq, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 192])
@pytest.mark.parametrize("n_rep", [1, 2, 3, 4, 6, 8, 12, 32])
def test_decode_kernel_int8_cache(cuda, n_rep, d, dt):
    """The int8 cache with its (B, KV, S) scales against the plain version,
    with a bf16 q (the tensor-core route) or an f32 q (the CUDA-core loop),
    at every head dim and n_rep of the kernel (32: four head groups of 8).
    Lengths 0, S, 1, 15 and 17 (ending inside and just past a 16-row tile),
    one chunk - 1 and + 1, and ragged; S = 600 is no multiple of the chunk,
    so a chunk's scales start at offsets that are not multiples of 16
    bytes.  Under a bf16 q also ``return_lse``: the out the bits of the call
    without it, within bf16's 2e-2 of the plain version's f32 step-by-step
    oracle (the kernel rounds p * v_scale to bf16 before PV, as the
    reference does and that oracle does not), and the lse within f32's 3e-5
    (it sums p unrounded, as the oracle)."""
    s, kv = 600, 2
    chunk = decode_plan(8, kv, s, d, 1, n_rep, mma=dt == "bf16").chunk
    lens = [0, s, 1, 15, 17, chunk - 1, chunk + 1, 333]
    b = len(lens)
    _, (q,) = _inputs(17, [(b, kv * n_rep, d)], dt, cuda)
    kq, vq, ks, vs = _int8_cache(18, b, kv, s, d, cuda)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, kq, vq, lens, k_scale=ks, v_scale=vs, impl="kernel")
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got[1:], ref.decode_attention_ref(q, kq, vq, lens, k_scale=ks, v_scale=vs)[1:], dt)
    if dt == "bf16":
        out, lse = ops.decode_attention(q, kq, vq, lens, k_scale=ks, v_scale=vs, return_lse=True,
                                        impl="kernel")
        assert torch.equal(out, got)
        want, want_lse = ref.decode_attention_ref(q, kq, vq, lens, k_scale=ks, v_scale=vs,
                                                  return_lse=True)
        assert bool((lse[0] == float("-inf")).all()) and bool(lse[1:].isfinite().all())
        _close(out[1:], want[1:], "bf16")
        _close(lse[1:], want_lse[1:], "f32")


@pytest.mark.cuda
def test_decode_kernel_int8_short_long_short(cuda):
    """The tensor-core route at one head dim, a short cache (one 256-row
    chunk a CTA: 72 KB of shared memory), a long one (whose plan asks the
    card how many clusters fit, at 55 KB), then the short one again: each
    launch keeps the shared memory it needs (one opt-in record per kernel
    for launches and queries alike) and matches the plain version."""
    for s in (1024, 4096, 1024):
        b, kv, d = 4, 8, 128
        _, (q,) = _inputs(21, [(b, 4 * kv, d)], "bf16", cuda)
        kq, vq, ks, vs = _int8_cache(22, b, kv, s, d, cuda)
        lens = torch.tensor([s, s - 1, s // 2, 17], dtype=torch.int32, device=cuda)
        got = ops.decode_attention(q, kq, vq, lens, k_scale=ks, v_scale=vs, impl="kernel")
        _close(got, ref.decode_attention_ref(q, kq, vq, lens, k_scale=ks, v_scale=vs), "bf16")


@pytest.mark.cuda
def test_decode_kernel_int8_ignores_rows_and_scales_past_length(cuda):
    """Values and scales past each length (stale after a slot is reused)
    change nothing."""
    _, (q,) = _inputs(19, [(2, 8, 128)], "bf16", cuda)
    kq, vq, ks, vs = _int8_cache(20, 2, 2, 300, 128, cuda)
    lens = torch.tensor([100, 257], dtype=torch.int32, device=cuda)
    out1 = ops.decode_attention(q, kq, vq, lens, k_scale=ks, v_scale=vs, impl="kernel")
    past = (torch.arange(300, device=cuda)[None, None, :] >= lens[:, None, None].long()).expand(2, 2, 300)
    kq2, vq2 = kq.clone(), vq.clone()
    kq2[past], vq2[past] = 127, -127
    out2 = ops.decode_attention(q, kq2, vq2, lens, k_scale=torch.where(past, 1e6, ks),
                                v_scale=torch.where(past, 1e6, vs), impl="kernel")
    assert torch.equal(out1, out2)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,quant", [("granite-8b", False), ("granite-8b", True),
                                        ("olmoe-1b-7b", True), ("mamba2-370m", False),
                                        ("zamba2-2.7b", True), ("pixtral-12b", True)])
def test_captured_engine_matches_the_eager_step(cuda, arch, quant):
    """The engine's decode step, captured once at the first admission as a
    CUDA graph, against the same engine stepping eagerly (told not to
    capture): equal tokens over queueing, slot reuse and staggered
    finishes (bf16 REDUCED), each replay counting the captured step's
    launches, and every cache leaf and parameter kept in its storage."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    from repro_torch.serving.engine import InstanceEngine, ServeRequest

    cfg = get_config(arch, reduced=True).replace(kv_quant=quant)
    params = TF.init_params(cfg, 0, device=cuda)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 6 + 3 * (i % 2)).astype(np.int32) for i in range(5)]
    out = {}
    for mode in ("graph", "eager"):
        eng = InstanceEngine(cfg, params, n_slots=3, max_seq=40)
        assert eng._graph is None and eng._capture_pending
        if mode == "eager":
            eng._capture_pending = False
        ptrs = [t.data_ptr() for t in _leaves(eng.caches) + _leaves(params)]
        ops.reset_launch_counts()
        for i, p in enumerate(prompts):
            eng.submit(ServeRequest(i, p, 4 + i % 3))
        done = eng.run_until_done()
        counts = ops.launch_counts()
        out[mode] = {r.rid: r.out_tokens for r in done}
        out[mode + "_launches"] = counts
        assert len(done) == 5
        assert (eng._graph is not None) == (mode == "graph")
        if mode == "graph":
            assert eng._graph_launches["rmsnorm"] > 0
        assert [t.data_ptr() for t in _leaves(eng.caches) + _leaves(params)] == ptrs
    assert out["graph"] == out["eager"]
    assert out["graph_launches"] == out["eager_launches"]


@pytest.mark.cuda
def test_engine_captures_at_its_first_admission_only(cuda):
    """A prefill-only engine (a disaggregated prefill pool's) never
    captures; an engine captures at its first admission, local or
    migrated, and never again; a migrated request then decodes as a local
    one does (bf16 REDUCED)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    from repro_torch.serving.engine import InstanceEngine, ServeRequest

    cfg = get_config("granite-8b", reduced=True)
    params = TF.init_params(cfg, 0, device=cuda)
    prompts = [np.arange(3 + i, 11 + i, dtype=np.int32) for i in range(2)]
    src = InstanceEngine(cfg, params, n_slots=2, max_seq=32)
    dst = InstanceEngine(cfg, params, n_slots=2, max_seq=32)
    local = InstanceEngine(cfg, params, n_slots=2, max_seq=32)
    req = ServeRequest(0, prompts[0], 5)
    first, one = src.prefill_only(req)
    assert src._graph is None and src._capture_pending
    assert dst._graph is None
    assert dst.admit_prefilled(req, first, one)
    graph = dst._graph
    assert graph is not None and not dst._capture_pending
    dst.run_until_done()
    dst.submit(ServeRequest(1, prompts[1], 4))
    dst.run_until_done()
    assert dst._graph is graph
    local.submit(ServeRequest(0, prompts[0], 5))
    assert local.run_until_done()[0].out_tokens == req.out_tokens


@pytest.mark.cuda
def test_capture_survives_a_collection_of_a_dropped_graph(cuda):
    """A dropped engine's captured graph held in a reference cycle lives
    until the cyclic collector runs; if that happens while another engine
    captures, destroying the graph invalidates the capture.  The graph
    becomes cyclic garbage inside the capture, with the collector on and
    its threshold at 1: the capture must still succeed and the engine
    decode as the dropped one did (bf16 REDUCED)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    from repro_torch.serving.engine import InstanceEngine, ServeRequest

    cfg = get_config("granite-8b", reduced=True)
    params = TF.init_params(cfg, 0, device=cuda)
    prompt = np.arange(3, 12, dtype=np.int32)
    old = InstanceEngine(cfg, params, n_slots=2, max_seq=32)
    old.submit(ServeRequest(0, prompt, 4))
    want = old.run_until_done()[0].out_tokens
    assert old._graph is not None
    holder = [old]
    del old
    eng = InstanceEngine(cfg, params, n_slots=2, max_seq=32)
    decode_all, calls = eng._decode_all, []

    def drop_then_decode():
        calls.append(1)
        if len(calls) == 2:  # the capture (the first call is its warm-up)
            cycle = {"graph": holder.pop()._graph}  # the engine itself is freed here
            cycle["self"] = cycle
            del cycle  # young cyclic garbage holding the only reference to the graph
        return decode_all()

    eng._decode_all = drop_then_decode
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        eng.submit(ServeRequest(0, prompt, 4))
        got = eng.run_until_done()[0].out_tokens
    finally:
        gc.set_threshold(*threshold)
    assert len(calls) == 2 and not holder and eng._graph is not None
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-8b", "whisper-large-v3"])
def test_batched_prefill_and_decode_run_on_the_kernels(cuda, arch):
    """A prefill of 3 sequences (the last position of each is a strided
    slice of the batch: the rmsnorm kernel takes it made contiguous) and two
    decode steps on the kernels, against the plain path, f32 REDUCED;
    whisper with its frames.  Logits over the real vocab within 1e-4 of
    their scale, the model-level f32 tolerance of tests/test_torch_model.py
    and test_torch_families.py (each kernel's own 3e-5 grows through the
    layers: whisper's 2 + 2 layers part by 2.5e-4 at logits near 1.5).  A
    float64 run of the plain path on the same weights tells that growth from
    a kernel fault: the kernel path may sit no farther from it than the
    plain path does, plus the kernels' own f32 tolerance, 3e-5 of the
    scale."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF

    cfg = get_config(arch, reduced=True).replace(dtype=torch.float32)
    params = TF.init_params(cfg, 0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 9))).to(cuda)
    frames = None
    if cfg.family == "encdec":
        shape = (3, cfg.n_frontend_tokens, cfg.d_model)
        frames = torch.from_numpy(np.random.default_rng(2).standard_normal(shape) * 0.02).float().to(cuda)

    def widen(tree):
        return {k: widen(v) if isinstance(v, dict) else v.double() for k, v in tree.items()}

    runs = {"kernel": (cfg, params), "ref": (cfg, params),
            "f64": (cfg.replace(dtype=torch.float64), widen(params))}
    out, feed = {}, []
    for name, (c, p) in runs.items():  # all fed the tokens the kernel path picks
        impl = "kernel" if name == "kernel" else "ref"
        with ops.use_impl(impl):
            before = ops.launch_counts()
            caches = TF.init_caches(c, 3, 16, device=cuda)
            logits, caches = TF.prefill_logits(c, p, toks.int(), caches, frames)
            steps = [logits]
            for t in range(2):
                if impl == "kernel":
                    feed.append(steps[-1].argmax(-1).int())
                logits, caches = TF.decode_logits(c, p, feed[t], caches)
                steps.append(logits)
            out[name] = torch.stack(steps)[..., :cfg.vocab_size].double().cpu().numpy()
            launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
            fwd = [launched[k] for k in ("rmsnorm", "flash_attention", "decode_attention")]
            assert all(fwd) == (impl == "kernel"), launched
            assert launched["rmsnorm_bwd"] == launched["flash_attention_bwd"] == 0, launched
    got, want, f64 = out["kernel"], out["ref"], out["f64"]
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=1e-4)
    assert np.abs(got - f64).max() <= np.abs(want - f64).max() + 3e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_attention_kernels_reject_other_head_dims(cuda, dt):
    """A head dim with no instantiation (here 72, 160 bytes in f32 are 40
    lanes) raises a clear error in the wrapper, never reaches a launch."""
    x = torch.zeros(1, 8, 2, 72, device=cuda, dtype=DTYPES[dt])
    with pytest.raises(ValueError, match="unsupported shapes"):
        ops.flash_attention(x, x, x, impl="kernel")
    cache = torch.zeros(1, 2, 8, 72, device=cuda, dtype=DTYPES[dt])
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="unsupported shapes"):
        ops.decode_attention(x[:, 0], cache, cache, lens, impl="kernel")


def test_attention_head_dims_cover_zamba2():
    """zamba2's shared block runs flash and decode at D = d_model / n_heads =
    80 (full) and at REDUCED's head dim, natively."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as decode
    from repro_torch.kernels import flash_attention as flash

    assert get_config("zamba2-2.7b").resolved_head_dim == 80
    for reduced in (False, True):
        d = get_config("zamba2-2.7b", reduced=reduced).resolved_head_dim
        assert d in flash.HEAD_DIMS and d in decode.HEAD_DIMS


def test_attention_head_dims_cover_all_configs():
    """Every registered config, full and REDUCED, runs its attention on the
    kernels: the GQA head dim in both wrappers' HEAD_DIMS and its n_rep in
    the decode kernel's N_REPS; MLA's qk dim in flash's (natively or padded;
    its decode is plain products); the SSM arch has no attention."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.kernels import decode_attention as decode
    from repro_torch.kernels import flash_attention as flash

    assert len(ARCHS) == 13
    for arch in ARCHS:
        for reduced in (False, True):
            cfg = get_config(arch, reduced=reduced)
            if cfg.family == "ssm":
                continue
            if cfg.attn == "mla":
                d = cfg.mla_qk_head_dim
                assert d in flash.HEAD_DIMS or d in flash.PADDED_HEAD_DIMS, cfg.name
                continue
            d, n_rep = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
            assert d in flash.HEAD_DIMS and d in decode.HEAD_DIMS, cfg.name
            assert n_rep in decode.N_REPS, cfg.name
    assert get_config("nemotron-4-340b").resolved_head_dim == 192


# ---------------------------------------------------------------------------
# The backward kernels (port-only: the TPU side has none) against their plain
# versions, on the card
# ---------------------------------------------------------------------------


def _rand(seed, shape, dt, device, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device=device, dtype=DTYPES[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [
    (4, 7, 64), (130, 256), (5, 13), (3000, 1280), (2, 18432), (1, 4096),
    # rows below, at and one past the tile count (256: one row a tile, then
    # two with a ring of 2), and nemotron's width at the train loop's rows
    (255, 512), (256, 512), (257, 512), (8192, 18432),
])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, shape, dt):
    """dx and dw against the explicit formula in f32, and two runs bit-equal;
    ragged d (13: the scalar path), many row tiles (3000 rows: 12 rows a
    tile) and nemotron's d = 18432 (a 72 KB shared dw partial, one or two
    row slots)."""
    from repro_torch.kernels import rmsnorm as rms

    x, g = _rand(20, shape, dt, cuda), _rand(21, shape, dt, cuda)
    w = 1 + _rand(22, shape[-1:], dt, cuda, 0.3)
    before = ops.launch_counts()["rmsnorm_bwd"]
    dx, dw = rms.fused_rmsnorm_bwd(x, w, g)
    assert ops.launch_counts()["rmsnorm_bwd"] == before + 1
    again = rms.fused_rmsnorm_bwd(x, w, g)
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
    want_dx, want_dw = ref.rmsnorm_bwd_ref(x, w, g)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    _close(dx, want_dx, dt)
    # dw sums over every row: held at the tolerance of its scale
    scale = max(1.0, float(want_dw.float().abs().max()))
    np.testing.assert_allclose(dw.float().cpu().numpy(), want_dw.float().cpu().numpy(),
                               atol=TOL[dt]["atol"] * scale, rtol=TOL[dt]["rtol"])


BWD_FLASH_SHAPES = [  # b, sq, sk, h, kv, d, causal
    (2, 64, 64, 4, 2, 16, True), (1, 100, 100, 8, 2, 64, True), (2, 130, 130, 8, 2, 128, True),
    (1, 300, 300, 32, 8, 128, True), (2, 200, 333, 4, 1, 64, False), (1, 77, 150, 4, 4, 16, False),
    (1, 96, 96, 4, 4, 32, True), (1, 100, 100, 4, 4, 80, True), (2, 70, 70, 6, 3, 96, True),
    (1, 40, 40, 4, 4, 24, True), (1, 90, 90, 12, 1, 192, True), (1, 64, 120, 4, 2, 192, False),
    # many tiles with ragged tails: the train shape's heads, nemotron's n_rep
    # 12 at D = 192, whisper's cross-attention, zamba2's D = 80, MLA's 96, D = 24
    (1, 1031, 1031, 32, 8, 128, True), (1, 2048, 2048, 32, 8, 128, True),
    (1, 333, 333, 96, 8, 192, True), (1, 512, 1500, 20, 20, 64, False),
    (2, 257, 257, 10, 5, 80, True), (1, 190, 190, 40, 40, 96, True), (1, 129, 129, 4, 4, 24, True),
]


@pytest.mark.parametrize("n", [0, 1, 7, 255, 256, 257, 8192, 8193, 100_000])
@pytest.mark.parametrize("d,elem,vector", [
    (4096, 2, True), (4096, 4, True), (1280, 2, True), (18432, 2, True), (18432, 4, True),
    (13, 4, False), (40_000, 4, True), (50_000, 2, True),
])
def test_rmsnorm_bwd_plan(n, d, elem, vector):
    """The backward's launch plan from the shape alone: whole rows in at most
    TILES tiles covering every row once, 32-multiple CTAs of at most 512
    threads, 1 to 4 rows a step, slots that fit the shared memory beside the
    dw partial (two CTAs an SM where they can), none for ragged or too-wide
    rows."""
    from repro_torch.kernels import rmsnorm as rms

    rows_per_tile, n_tiles, threads, rps, stages = rms.bwd_plan(n, d, elem, vector)
    assert n_tiles <= rms.TILES and rows_per_tile >= 1
    assert (n_tiles - 1) * rows_per_tile < n <= n_tiles * rows_per_tile or n == n_tiles == 0
    assert threads % 32 == 0 and 32 <= threads <= rms.BWD_THREADS
    assert rps in (1, 2, rms.BWD_RPS)
    assert 0 <= stages <= min(rms.BWD_STAGES, -(-rows_per_tile // rps))
    per_slot = 2 * rps * d * elem + 8
    smem = 4 * d + stages * per_slot
    assert smem <= rms.SMEM_MAX
    if not vector or 4 * d + 2 * d * elem + 8 > rms.SMEM_MAX:
        assert stages == 0 and rps == 1  # the scalar path
    else:
        assert stages >= 1
        if stages >= 2 and 4 * d + 2 * per_slot <= rms.SMEM_SHARED:
            assert smem <= rms.SMEM_SHARED  # two CTAs share an SM
    # the plan is the card's argument list: it is the same for every call
    assert rms.bwd_plan(n, d, elem, vector) == (rows_per_tile, n_tiles, threads, rps, stages)


def test_rmsnorm_bwd_plan_rejects_a_partial_too_wide():
    from repro_torch.kernels import rmsnorm as rms

    with pytest.raises(ValueError, match="dw partial"):
        rms.bwd_plan(4, rms.SMEM_MAX // 4 + 1, 4, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", BWD_FLASH_SHAPES)
def test_flash_bwd_kernel_matches_plain(cuda, b, sq, sk, h, kv, d, causal, dt):
    """dq, dk, dv against the plain backward (P materialised, f32) on the
    kernel's own forward output and log-sum-exp: causal with Sq = Sk,
    non-causal with Sq != Sk (whisper's cross-attention), n_rep 1-12, every
    head dim the forward takes (24 zero-padded to 32), ragged lengths."""
    from repro_torch.kernels import flash_attention as flash

    q, do = _rand(23, (b, sq, h, d), dt, cuda), _rand(24, (b, sq, h, d), dt, cuda)
    k, v = _rand(25, (b, sk, kv, d), dt, cuda), _rand(26, (b, sk, kv, d), dt, cuda)
    for scale in (None, 0.3):
        o, lse = flash.flash_attention(q, k, v, causal=causal, softmax_scale=scale, return_lse=True)
        before = ops.launch_counts()["flash_attention_bwd"]
        got = flash.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, softmax_scale=scale)
        assert ops.launch_counts()["flash_attention_bwd"] == before + 1
        want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal, softmax_scale=scale)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            scale_w = max(1.0, float(w.float().abs().max()))
            np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(),
                                       atol=TOL[dt]["atol"] * scale_w, rtol=TOL[dt]["rtol"])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("seq", [512, 2048])
def test_backward_kernels_are_deterministic(cuda, dt, seq):
    """No float atomics: two runs on one input give equal bits (flash also
    at the train microbatch's 2048 tokens)."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rmsnorm as rms

    x, g, w = _rand(27, (2048, 4096), dt, cuda), _rand(28, (2048, 4096), dt, cuda), _rand(29, (4096,), dt, cuda)
    a, b = rms.fused_rmsnorm_bwd(x, w, g), rms.fused_rmsnorm_bwd(x, w, g)
    assert all(torch.equal(s, t) for s, t in zip(a, b))
    q, do = _rand(30, (2, seq, 16, 128), dt, cuda), _rand(31, (2, seq, 16, 128), dt, cuda)
    k, v = _rand(32, (2, seq, 4, 128), dt, cuda), _rand(33, (2, seq, 4, 128), dt, cuda)
    o, lse = flash.flash_attention(q, k, v, return_lse=True)
    a, b = flash.flash_attention_bwd(q, k, v, o, do, lse), flash.flash_attention_bwd(q, k, v, o, do, lse)
    assert all(torch.equal(s, t) for s, t in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 24, 32, 64, 80, 96, 128, 192])
def test_flash_bwd_f32_every_head_dim_ragged(cuda, d, causal):
    """The f32 backward at every head dim with lengths ragged past the
    rings' 64-row stages (Sk 197: three K/V tiles and a 5-row tail; Sq 133
    when not causal), n_rep 2, against the plain backward at 3e-5 of each
    gradient's scale; two runs bit-equal."""
    from repro_torch.kernels import flash_attention as flash

    sq = 197 if causal else 133
    q, do = _rand(46, (2, sq, 4, d), "f32", cuda), _rand(47, (2, sq, 4, d), "f32", cuda)
    k, v = _rand(48, (2, 197, 2, d), "f32", cuda), _rand(49, (2, 197, 2, d), "f32", cuda)
    o, lse = flash.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = flash.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    again = flash.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal)
    for g, w in zip(got, want):
        scale_w = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   atol=TOL["f32"]["atol"] * scale_w, rtol=TOL["f32"]["rtol"])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 24, 32, 64, 80, 96, 128, 192])
def test_flash_bwd_is_deterministic_at_every_head_dim(cuda, d, dt):
    """No float atomics: two runs give equal bits at every head dim, with
    GQA (n_rep 4) summed over 9 q-tiles a key block."""
    from repro_torch.kernels import flash_attention as flash

    q, do = _rand(50, (2, 520, 8, d), dt, cuda), _rand(51, (2, 520, 8, d), dt, cuda)
    k, v = _rand(52, (2, 520, 2, d), dt, cuda), _rand(53, (2, 520, 2, d), dt, cuda)
    o, lse = flash.flash_attention(q, k, v, return_lse=True)
    a, b = flash.flash_attention_bwd(q, k, v, o, do, lse), flash.flash_attention_bwd(q, k, v, o, do, lse)
    assert all(torch.equal(s, t) for s, t in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", BWD_FLASH_SHAPES)
def test_flash_forward_lse_matches_plain(cuda, b, sq, sk, h, kv, d, causal, dt):
    """return_lse: each row's log-sum-exp against the plain one (log2
    domain, f32 scores from the same inputs) at the kernel's tolerance, and
    the output bit-equal to the forward without it."""
    from repro_torch.kernels import flash_attention as flash

    q = _rand(41, (b, sq, h, d), dt, cuda)
    k, v = _rand(42, (b, sk, kv, d), dt, cuda), _rand(43, (b, sk, kv, d), dt, cuda)
    for scale in (None, 0.3):
        before = ops.launch_counts()["flash_attention"]
        o, lse = flash.flash_attention(q, k, v, causal=causal, softmax_scale=scale, return_lse=True)
        plain_o = flash.flash_attention(q, k, v, causal=causal, softmax_scale=scale)
        assert ops.launch_counts()["flash_attention"] == before + 2
        assert torch.equal(o, plain_o)
        want = ref.flash_attention_lse_ref(q, k, causal=causal, softmax_scale=scale)
        assert lse.shape == want.shape == (b, h, sq) and lse.dtype == torch.float32
        np.testing.assert_allclose(lse.cpu().numpy(), want.cpu().numpy(), **TOL[dt])


@pytest.mark.cuda
def test_flash_bwd_needs_the_forwards_lse(cuda):
    from repro_torch.kernels import flash_attention as flash

    q = _rand(44, (1, 40, 4, 64), "bf16", cuda)
    k = _rand(45, (1, 40, 2, 64), "bf16", cuda)
    o, lse = flash.flash_attention(q, k, k, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash.flash_attention_bwd(q, k, k, o, o)
    with pytest.raises(ValueError, match="lse"):
        flash.flash_attention_bwd(q, k, k, o, o, lse.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_bwd_rejects_other_head_dims(cuda, dt):
    from repro_torch.kernels import flash_attention as flash

    x = torch.zeros(1, 8, 2, 72, device=cuda, dtype=DTYPES[dt])
    with pytest.raises(ValueError, match="D=72"):
        flash.flash_attention_bwd(x, x, x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ops_gradients_go_through_the_backward_kernels(cuda, dt):
    """autograd through ops.rmsnorm and ops.flash_attention on the card
    takes the Functions: the backward kernels launch once each, and the
    gradients, for one fixed upstream gradient, match autograd of the
    plain versions within the tolerance of each gradient's scale."""
    x = _rand(34, (3, 50, 256), dt, cuda).requires_grad_()
    w = (1 + _rand(35, (256,), dt, cuda, 0.3)).requires_grad_()
    q = _rand(36, (2, 50, 8, 64), dt, cuda).requires_grad_()
    k, v = (_rand(s, (2, 50, 2, 64), dt, cuda).requires_grad_() for s in (37, 38))
    gy, go = _rand(39, (3, 50, 256), dt, cuda), _rand(40, (2, 50, 8, 64), dt, cuda)
    grads = {}
    for impl in ("kernel", "ref"):
        before = ops.launch_counts()
        with ops.use_impl(impl):
            torch.autograd.backward([ops.rmsnorm(x, w), ops.flash_attention(q, k, v)], [gy, go])
        launched = {n: c - before[n] for n, c in ops.launch_counts().items()}
        on = int(impl == "kernel")
        assert launched == {"rmsnorm": on, "flash_attention": on, "decode_attention": 0,
                            "rmsnorm_bwd": on, "flash_attention_bwd": on}
        grads[impl] = [t.grad.float().cpu().numpy() for t in (x, w, q, k, v)]
        for t in (x, w, q, k, v):
            t.grad = None
    for g, want in zip(grads["kernel"], grads["ref"]):
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g, want, atol=TOL[dt]["atol"] * scale, rtol=TOL[dt]["rtol"])


# ---------------------------------------------------------------------------
# The forward kernels' designs for the card: the f32 flash forward and the
# rmsnorm forward at every head dim and width their plans take
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n_rep", [1, 4, 6, 12])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 24, 32, 64, 80, 96, 128, 192])
def test_flash_f32_forward_every_head_dim(cuda, d, causal, n_rep):
    """The f32 forward at every head dim (24 zero-padded to 32), causal and
    full, ragged Sq 133 != Sk 197 (past the ring's 32- and 64-key tiles), n_rep
    1-12, the default and a non-default scale: against the plain version at
    3e-5, the log-sum-exp too, the output bit-equal with and without it, and
    two runs bit-equal."""
    from repro_torch.kernels import flash_attention as flash

    q = _rand(60, (2, 133, 2 * n_rep, d), "f32", cuda)
    k, v = _rand(61, (2, 197, 2, d), "f32", cuda), _rand(62, (2, 197, 2, d), "f32", cuda)
    for scale in (None, 0.3):
        kw = dict(causal=causal, softmax_scale=scale)
        o, lse = flash.flash_attention(q, k, v, return_lse=True, **kw)
        again = flash.flash_attention(q, k, v, **kw)
        assert torch.equal(o, again)
        _close(o, ref.flash_attention_ref(q, k, v, **kw), "f32")
        _close(lse, ref.flash_attention_lse_ref(q, k, **kw), "f32")


@pytest.mark.cuda
@pytest.mark.parametrize("block_q", [32, 64])
@pytest.mark.parametrize("d", [16, 24, 32, 64, 80, 96, 128, 192])
def test_flash_f32_forward_both_block_heights(cuda, d, block_q):
    """Both q-block heights fwd_plan picks (32 rows for 68 CTAs of 64, 64 rows
    for 544): 1031 causal query rows over 900 keys (rows past Sk see every
    key), against the plain version at 3e-5, two runs bit-equal; the bits do
    not depend on the height (a 64-row run's heads equal the same heads run
    alone in 32-row blocks)."""
    from repro_torch.kernels import flash_attention as flash

    h, kv = (4, 4) if block_q == 32 else (16, 4)
    assert flash.fwd_plan(2 if block_q == 64 else 1, 1031, 900, h, d, 4).block_q == block_q
    b = 2 if block_q == 64 else 1
    q = _rand(63, (b, 1031, h, d), "f32", cuda)
    k, v = _rand(64, (b, 900, kv, d), "f32", cuda), _rand(65, (b, 900, kv, d), "f32", cuda)
    got = flash.flash_attention(q, k, v)
    assert torch.equal(got, flash.flash_attention(q, k, v))
    _close(got, ref.flash_attention_ref(q, k, v), "f32")
    if block_q == 64:  # one KV head's group of one sequence: 68 q-blocks of 64, so 32-row blocks
        one = flash.flash_attention(*(t[:1, :, :m].contiguous() for t, m in ((q, 4), (k, 1), (v, 1))))
        assert torch.equal(one, got[:1, :, :4])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 37, 512, 8192])
@pytest.mark.parametrize("d", RMS_PLAN_D + [40000])
def test_rmsnorm_forward_every_width(cuda, d, n, dt):
    """The rmsnorm forward at every width its plan sees (one warp to 16 warps
    a row, the scalar path at d 1, 13 and 1001, the two-pass CTA at d 40000)
    and 1 to 8192 rows, against the plain version at the reference's
    tolerance, two runs bit-equal; also from a view 4 bytes off 16-byte
    alignment (the scalar path at any d)."""
    if n * d > 8192 * 4096:
        n = 8192 * 4096 // d  # the widest rows at as many as 128 MB of f32 holds
    x, w = _rand(66, (n, d), dt, cuda), 1 + _rand(67, (d,), dt, cuda, 0.3)
    before = ops.launch_counts()["rmsnorm"]
    got = ops.rmsnorm(x, w, impl="kernel")
    assert torch.equal(got, ops.rmsnorm(x, w, impl="kernel"))
    assert ops.launch_counts()["rmsnorm"] == before + 2
    _close(got, ref.rmsnorm_ref(x, w), dt)
    flat = torch.empty(n * d + 2, device=cuda, dtype=x.dtype)
    off = flat[2:].view(n, d)  # 4 (bf16) or 8 (f32) bytes past the allocation's alignment
    off.copy_(x)
    _close(ops.rmsnorm(off, w, impl="kernel"), ref.rmsnorm_ref(x, w), dt)


# ---------------------------------------------------------------------------
# Sequence-sharded serving: the decode kernel's lse, the flash forward's
# query offset (the CPU tests of the merge and the offset are in
# tests/test_torch_shards.py)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b,s,h,kv,d", [(5, 600, 8, 2, 128), (5, 300, 12, 2, 192), (5, 150, 4, 4, 64)])
def test_decode_kernel_lse(cuda, b, s, h, kv, d, quant, dt):
    """``return_lse``: the kernel's (out, lse) against the plain version's
    step-by-step f32 (out, lse), over lengths 0, S, 1, one chunk + 1 and
    ragged, in bf16 and int8 with an f32 or bf16 q; a row of length 0 gives
    out 0 and lse -inf; the out is the bits of the call without lse."""
    chunk = decode_plan(b, kv, s, d, 1 if quant else (2 if dt == "bf16" else 4), h // kv,
                        mma=quant and dt == "bf16").chunk
    _, (q, k, v) = _inputs(70, [(b, h, d), (b, kv, s, d), (b, kv, s, d)], dt, cuda)
    scales = {}
    if quant:
        k, v, ks, vs = _int8_cache(71, b, kv, s, d, cuda)
        scales = {"k_scale": ks, "v_scale": vs}
    lens = torch.tensor([0, s, 1, chunk + 1, s * 2 // 3], dtype=torch.int32, device=cuda)
    out, lse = ops.decode_attention(q, k, v, lens, return_lse=True, impl="kernel", **scales)
    assert torch.equal(out, ops.decode_attention(q, k, v, lens, impl="kernel", **scales))
    want, want_lse = ref.decode_attention_ref(q, k, v, lens, return_lse=True, **scales)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert lse.shape == (b, h) and lse.dtype == torch.float32
    assert bool((lse[0] == float("-inf")).all()) and bool(lse[1:].isfinite().all())
    _close(out, want, dt)
    _close(lse[1:], want_lse[1:], "f32")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("n", [4, 16])
def test_decode_kernel_slices_merged(cuda, n, quant, dt):
    """The cache cut into n sequence slices, the kernel with lse over each
    (its lengths cut to it), merged by ``ops.merge_partials``: the whole
    call's out, within the reference's tolerance; lengths that end inside
    the first slice leave the later ones empty."""
    b, s, h, kv, d = 4, 4096, 32, 8, 128
    _, (q, k, v) = _inputs(72, [(b, h, d), (b, kv, s, d), (b, kv, s, d)], dt, cuda)
    scales = {}
    if quant:
        k, v, ks, vs = _int8_cache(73, b, kv, s, d, cuda)
        scales = {"k_scale": ks, "v_scale": vs}
    lens = torch.tensor([s, 3000, s // n - 5, 1], dtype=torch.int32, device=cuda)
    whole = ops.decode_attention(q, k, v, lens, impl="kernel", **scales)
    outs, lses = [], []
    for i in range(n):
        a, e = i * s // n, (i + 1) * s // n
        cut = {key: t[:, :, a:e].contiguous() for key, t in scales.items()}
        o, l = ops.decode_attention(q, k[:, :, a:e].contiguous(), v[:, :, a:e].contiguous(),
                                    (lens - a).clamp(0, e - a).int(), return_lse=True,
                                    impl="kernel", **cut)
        outs.append(o)
        lses.append(l)
    out, _ = ops.merge_partials(torch.stack(outs), torch.stack(lses))
    _close(out, whole, dt)
    _close(out, ref.decode_attention_ref(q, k, v, lens, **scales), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,sk,h,kv,d", [(1, 512, 512, 32, 8, 128), (2, 300, 300, 8, 2, 96),
                                          (1, 700, 700, 16, 16, 64), (2, 200, 333, 8, 2, 64)])
def test_flash_kernel_q_offset_blocks(cuda, b, s, sk, h, kv, d, causal, dt):
    """q cut into 4 row blocks (uneven), each through the kernel at its
    offset with its lse, concatenated: the whole call's out and lse, and
    the plain version's at each offset."""
    from repro_torch.kernels import flash_attention as flash

    _, (q, k, v) = _inputs(74, [(b, s, h, d), (b, sk, kv, d), (b, sk, kv, d)], dt, cuda)
    cuts = [0, s // 5, s // 2, s - 37, s]
    whole, whole_lse = flash.flash_attention(q, k, v, causal=causal, return_lse=True)
    outs, lses = [], []
    for a, e in zip(cuts, cuts[1:]):
        qb = q[:, a:e].contiguous()
        o, l = flash.flash_attention(qb, k, v, causal=causal, return_lse=True, q_offset=a)
        _close(o, ref.flash_attention_ref(qb, k, v, causal=causal, q_offset=a), dt)
        _close(l, ref.flash_attention_lse_ref(qb, k, causal=causal, q_offset=a), "f32")
        outs.append(o)
        lses.append(l)
    _close(torch.cat(outs, dim=1), whole, dt)
    _close(torch.cat(lses, dim=2), whole_lse, "f32")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,sk,h,kv,d", [(1, 512, 512, 32, 8, 128), (2, 300, 300, 8, 2, 96),
                                          (1, 700, 700, 16, 16, 64), (2, 200, 333, 8, 2, 64),
                                          (1, 333, 333, 12, 1, 192), (1, 129, 129, 4, 4, 24)])
def test_flash_bwd_kernel_q_offset_blocks(cuda, b, s, sk, h, kv, d, causal, dt):
    """q cut into 4 row blocks (uneven; offsets not multiples of the
    kernels' 32- or 64-row q-tiles), each through the forward with its lse
    and the backward at its offset: each block's (dq, dk, dv) against the
    plain backward at that offset, within the tolerance of each gradient's
    scale; under causal the keys past the block's last row get dk = dv = 0
    exactly; two runs bit-equal; the blocks' dq concatenated and their dk
    and dv summed are the whole backward call's; the offset launches are
    counted."""
    from repro_torch.kernels import flash_attention as flash

    _, (q, do, k, v) = _inputs(75, [(b, s, h, d), (b, s, h, d), (b, sk, kv, d), (b, sk, kv, d)],
                               dt, cuda)
    cuts = [0, s // 5, s // 2, s - 37, s]

    def held(got, want):
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            scale_w = max(1.0, float(w.float().abs().max()))
            np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(),
                                       atol=TOL[dt]["atol"] * scale_w, rtol=TOL[dt]["rtol"])

    dqs, dk, dv = [], torch.zeros(k.shape, device=cuda), torch.zeros(v.shape, device=cuda)
    before = ops.variant_counts()["flash_attention_bwd_q_offset"]
    for a, e in zip(cuts, cuts[1:]):
        qb, dob = q[:, a:e].contiguous(), do[:, a:e].contiguous()
        o, lse = flash.flash_attention(qb, k, v, causal=causal, return_lse=True, q_offset=a)
        got = flash.flash_attention_bwd(qb, k, v, o, dob, lse, causal=causal, q_offset=a)
        again = flash.flash_attention_bwd(qb, k, v, o, dob, lse, causal=causal, q_offset=a)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        held(got, ref.flash_attention_bwd_ref(qb, k, v, o, dob, lse, causal=causal, q_offset=a))
        if causal:
            assert not got[1][:, e:].any() and not got[2][:, e:].any()
        dqs.append(got[0])
        dk += got[1].float()
        dv += got[2].float()
    assert ops.variant_counts()["flash_attention_bwd_q_offset"] == before + 2 * 3
    o, lse = flash.flash_attention(q, k, v, causal=causal, return_lse=True)
    whole = flash.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    held((torch.cat(dqs, dim=1), dk, dv), [t.float() if i else t for i, t in enumerate(whole)])
