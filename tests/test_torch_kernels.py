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


@pytest.mark.parametrize("n_rep,groups", [(1, 1), (3, 1), (6, 1), (8, 1), (12, 2)])
@pytest.mark.parametrize("b,kv,s,d,elem", [
    (4, 8, 552, 192, 2), (4, 8, 552, 192, 4), (3, 8, 1000, 192, 4), (1, 2, 4096, 192, 2),
    (1, 1, 1, 192, 4), (4, 8, 552, 128, 2), (4, 20, 1500, 64, 2), (1, 1, 100, 16, 4)])
def test_decode_plan_splits_the_heads_into_groups(n_rep, groups, b, kv, s, d, elem):
    """n_rep above 8 (nemotron's 12) splits into equal groups of at most 8
    heads, each group a cluster of its own (grid y = KV x groups) over the
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
@pytest.mark.parametrize("n_rep", [3, 6, 12])
def test_decode_kernel_new_n_reps(cuda, n_rep, d, dt):
    """n_rep 3 (nemotron REDUCED), 6 (grok-1) and 12 (nemotron: two head
    groups of 6 over one cache) at D = 16, 128 and 192 (a row of 24 lanes;
    two 16-byte vectors a lane in f32).  Lengths 0, S, 1, one chunk + 1 and
    ragged."""
    b, s, kv = 5, 600, 2
    chunk = decode_plan(b, kv, s, d, 2 if dt == "bf16" else 4, n_rep).chunk
    _, (q, k, v) = _inputs(16, [(b, kv * n_rep, d), (b, kv, s, d), (b, kv, s, d)], dt, cuda)
    lens = torch.tensor([0, s, 1, chunk + 1, 333], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lens, impl="kernel")
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got[1:], ref.decode_attention_ref(q, k, v, lens)[1:], dt)


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
@pytest.mark.parametrize("shape", [(4, 7, 64), (130, 256), (5, 13), (3000, 1280), (2, 18432), (1, 4096)])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, shape, dt):
    """dx and dw against the explicit formula in f32; ragged d (13: the
    scalar path), many row tiles (3000 rows: 3 rows a tile) and nemotron's
    d = 18432 (a 72 KB shared dw partial)."""
    from repro_torch.kernels import rmsnorm as rms

    x, g = _rand(20, shape, dt, cuda), _rand(21, shape, dt, cuda)
    w = 1 + _rand(22, shape[-1:], dt, cuda, 0.3)
    before = ops.launch_counts()["rmsnorm_bwd"]
    dx, dw = rms.fused_rmsnorm_bwd(x, w, g)
    assert ops.launch_counts()["rmsnorm_bwd"] == before + 1
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
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", BWD_FLASH_SHAPES)
def test_flash_bwd_kernel_matches_plain(cuda, b, sq, sk, h, kv, d, causal, dt):
    """dq, dk, dv against the plain backward (P materialised, f32) on the
    kernel's own forward output: causal with Sq = Sk, non-causal with Sq !=
    Sk (whisper's cross-attention), n_rep 1-12, every head dim the forward
    takes (24 zero-padded to 32), ragged lengths."""
    from repro_torch.kernels import flash_attention as flash

    q, do = _rand(23, (b, sq, h, d), dt, cuda), _rand(24, (b, sq, h, d), dt, cuda)
    k, v = _rand(25, (b, sk, kv, d), dt, cuda), _rand(26, (b, sk, kv, d), dt, cuda)
    for scale in (None, 0.3):
        o = flash.flash_attention(q, k, v, causal=causal, softmax_scale=scale)
        before = ops.launch_counts()["flash_attention_bwd"]
        got = flash.flash_attention_bwd(q, k, v, o, do, causal=causal, softmax_scale=scale)
        assert ops.launch_counts()["flash_attention_bwd"] == before + 1
        want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal, softmax_scale=scale)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            scale_w = max(1.0, float(w.float().abs().max()))
            np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(),
                                       atol=TOL[dt]["atol"] * scale_w, rtol=TOL[dt]["rtol"])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_backward_kernels_are_deterministic(cuda, dt):
    """No float atomics: two runs on one input give equal bits."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rmsnorm as rms

    x, g, w = _rand(27, (2048, 4096), dt, cuda), _rand(28, (2048, 4096), dt, cuda), _rand(29, (4096,), dt, cuda)
    a, b = rms.fused_rmsnorm_bwd(x, w, g), rms.fused_rmsnorm_bwd(x, w, g)
    assert all(torch.equal(s, t) for s, t in zip(a, b))
    q, do = _rand(30, (2, 512, 16, 128), dt, cuda), _rand(31, (2, 512, 16, 128), dt, cuda)
    k, v = _rand(32, (2, 512, 4, 128), dt, cuda), _rand(33, (2, 512, 4, 128), dt, cuda)
    o = flash.flash_attention(q, k, v)
    a, b = flash.flash_attention_bwd(q, k, v, o, do), flash.flash_attention_bwd(q, k, v, o, do)
    assert all(torch.equal(s, t) for s, t in zip(a, b))


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
