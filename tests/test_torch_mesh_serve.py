"""The port's sharded prefill and decode (DTensor over a ``torch.distributed``
device mesh) against the JAX package's unsharded ones.

One spawn of 4 gloo CPU processes runs a prefill of 4 prompts and 3 decode
steps of each case below, the caches and parameters placed by the full
configs' sharding rules, through the constraint points and the ops' DTensor
paths (the plain versions on this CPU):

- granite-8b on a (1, 4) ("data", "model") mesh: q's 4 heads over "model"
  beside its 2 whole KV heads (the divisibility fallback), so rank r reads
  KV head r // 2 (production granite's layout: 32 q heads over 16, 8 KV
  heads whole); ``cache_seq`` over "model", the prompt spanning two shards
  and the decode writes a third;
- granite-8b with ``kv_quant`` on (2, 2): the batch over "data", the int8
  cache and its f32 scales sequence-sharded over "model";
- qwen1.5-4b on (2, 2): sequence parallel ("seq" over "model"), k and v
  gathered once a layer;
- olmoe-1b-7b on (2, 2): experts over "model", the cache's KV heads over
  "model" and its lockstep (``uniform_decode``) append;
- whisper-large-v3 on (2, 2) with 6 frames: sequence parallel, so the
  encoder (non-causal), the decoder (causal, a query offset of 3 on the
  second "model" rank) and its cross-attention keep q's sequence shard, and
  the decode steps merge the partials of the self and the cross caches'
  sequence shards.  Two decode steps, not three: the reduced model
  amplifies f32 rounding at its third step, where on one row the unsharded
  port is already 5.9e-4 from JAX (and a sharded run 2.9e-4 from the
  unsharded one, in the gathered layout as well), past both tolerances;
- minicpm3-4b on (2, 2): sequence parallel, its latent cache (``ckv``,
  ``krope``) sequence-sharded over "model" and batch-sharded over "data",
  so the absorbed decode merges each rank's block (flash-decoding, as
  GQA's decode does);
- grok-1-314b on (2, 2): its 4 experts replicated, each expert's d_ff over
  "model" and d_model over "data" (FSDP), so the down projection contracts
  d_ff on each rank's blocks (a partial sum); its cache's sequence over
  "model".  Two decode steps, as whisper's: at a third the unsharded port
  is already 3.5e-4 from JAX on one row (the sharded run 3.1e-4, and
  4.5e-5 from the unsharded one);
- mamba2-370m on (1, 4) and zamba2-2.7b on (2, 2): the SSM mixer keeps its
  heads over "model" (the conv on each rank's channels, the SSD scan on its
  heads, the gated norm's statistic all-reduced); zamba2's shared
  attention block caches its KV heads over "model";
- nemotron-4-340b with one KV head and d_model 20 (``VARIANTS``, the same
  config on both sides) on (2, 2), its FSDP overlay on: the KV head stays
  whole on "model" while q's 2 heads split over it, and wk's and wv's rows
  are FSDP blocks over "data".  A decode step has 2 rows a rank, fewer
  than K = 20, so its wk and wv products contract d_model over "model" on
  permuted blocks (``sharding.idle_contraction``, as the reference
  contracts production nemotron's 8 rows a rank); so do the prefill's 12
  rows a rank, fewer than K = 20, as the reference's compiled prefill of
  this variant does.  Once with the f32 cache and once with
  ``kv_quant``'s int8 one.

Each worker also records what the MoE's products and the SSD scans ran on
(the output's placements, the operands' blocks; x's block), and the mesh
axis of every all-gather.

The rules shard no dimension that the axis does not divide, so the cases
give even blocks.  Uneven and empty ones (6 cache rows over the 4-way axis:
2, 2, 2 and 0; 7 query rows: 2, 2, 2 and 1) are placed by hand on the
ops themselves, decode and the flash forward, against their unsharded calls.

Decode keeps the cache's sequence shard (flash-decoding: each rank's slice,
the partials merged), and a prefill under sequence parallelism keeps q's
sequence shard: each worker records the local operand shape of every
all-gather that the prefill and the decode steps issue, and the parent
holds them to the layouts.

The weights are JAX's init carried over through ``models.bridge``.  Each
worker also runs the case unsharded (plain tensors, no rules).  The parent
holds each pass's logits and every cache leaf after the prefill and after
the last step to the unsharded run within the f32 tolerance 3e-5
(tests/test_kernels.py:16-17), and to JAX's prefill and decode steps within
1e-4, the tolerance of the port's unsharded f32 model against JAX
(tests/test_torch_model.py, tests/test_torch_kvquant.py): the port sums in
another order than XLA, and on olmoe a logit of the unsharded port is 1.2x
3e-5 from JAX's.  Token ids are equal; f32 cache leaves are held relative to
their largest magnitude, lengths exactly, int8 entries apart by at most 1
(each side quantizes K/V that agree only to the last bits of f32) and few.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
WORLD = 4
TOL = dict(rtol=3e-5, atol=3e-5)  # tests/test_kernels.py's f32 tolerance
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_model.py's f32 model tolerance
BATCH, PROMPT, MAX_SEQ, STEPS = 4, 6, 16, 3
# name -> (arch, mesh "model" size, kv_quant, decode steps)
CASES = {
    "granite-8b": ("granite-8b", 4, False, STEPS),
    "granite-8b-int8": ("granite-8b", 2, True, STEPS),
    "qwen1.5-4b": ("qwen1.5-4b", 2, False, STEPS),
    "olmoe-1b-7b": ("olmoe-1b-7b", 2, False, STEPS),
    "whisper-large-v3": ("whisper-large-v3", 2, False, 2),
    "minicpm3-4b": ("minicpm3-4b", 2, False, STEPS),
    "grok-1-314b": ("grok-1-314b", 2, False, 2),
    "mamba2-370m": ("mamba2-370m", 4, False, STEPS),
    "zamba2-2.7b": ("zamba2-2.7b", 2, False, STEPS),
    "nemotron-4-340b-kv1": ("nemotron-4-340b", 2, False, STEPS),
    "nemotron-4-340b-kv1-int8": ("nemotron-4-340b", 2, True, STEPS),
}
# name -> fields replaced in the reduced config, on both sides
KV1 = {"n_kv_heads": 1, "n_heads": 2, "d_model": 20}
VARIANTS = {"nemotron-4-340b-kv1": KV1, "nemotron-4-340b-kv1-int8": KV1}
# the MoE product that contracts a sharded index: grok-1's down projection
# (d_ff over "model"), olmoe's combine (the experts over "model")
MOE_CONTRACTED = {"grok-1-314b": "gecf,efd->gecd", "olmoe-1b-7b": "gsec,gecd->gsd"}
SSM_CASES = ("mamba2-370m", "zamba2-2.7b")

FRAMES = 6  # whisper's frames: blocks of 2, 2, 2, 0 over a 4-way axis

WORKER = textwrap.dedent("""
    import json, sys

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import _with_rules, make_rules
    from repro_torch.models import bridge
    from repro_torch.models import transformer as TF

    rank, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    cases, variants, batch, prompt, max_seq, n_frames = json.loads(sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)
    meshes = {m: make_host_mesh(model=m) for m in (2, 4)}

    def full(t):
        return t.full_tensor() if sh.is_dtensor(t) else t

    def gathered(tree, path=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(gathered(v, f"{path}{k}/"))
            return out
        return {path[:-1]: full(tree).numpy().copy()}  # the plain run writes in place

    def placed(tree):
        return {k: [str(p) for p in v.placements] for k, v in tree_items(tree)}

    def tree_items(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from tree_items(v, f"{path}{k}/")
            else:
                yield f"{path}{k}", v

    axis_of = {mesh.get_group(i).group_name: n for mesh in meshes.values()
               for i, n in enumerate(mesh.mesh_dim_names)}

    class Gathers(TorchDispatchMode):
        # the local operand shape of each all-gather issued below DTensor,
        # and the mesh axis it gathers over; the mesh axis and operand shape
        # of each all_to_all_single (a permute)

        def __init__(self):
            super().__init__()
            self.shapes, self.axes, self.permutes = [], [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func.namespace == "_c10d_functional" and func.__name__.startswith("all_gather"):
                self.shapes.append(list(args[0].shape))
                self.axes.append(axis_of[args[2]])
            if func.namespace == "_c10d_functional" and func.__name__.startswith("all_to_all"):
                self.permutes.append([axis_of[args[3]], list(args[0].shape)])
            return func(*args, **(kwargs or {}))

    from repro_torch.kernels import ops
    from repro_torch.models import attention, mamba2, moe

    products, ssd_x = [], []  # what the sharded MoE products and SSD scans ran on
    # the sharded K/V projections by pass: the output's placements, w's
    # block, and the all-gathers and permutes issued inside the product
    kv_proj, phase = {"prefill": [], "decode": []}, []

    def recorded_einsum(eq, *ts):
        out = sh.einsum(eq, *ts)
        if sh.is_dtensor(out):
            products.append([eq, ["P" if p.is_partial() else str(p) for p in out.placements],
                             [list(t.to_local().shape) for t in ts if sh.is_dtensor(t)]])
        return out

    ssd = mamba2.ssd_chunked

    def recorded_ssd(x, *a, **kw):
        if not sh.is_dtensor(x):  # a rank's block (the DTensor call runs it on one)
            ssd_x.append(list(x.shape))
        return ssd(x, *a, **kw)

    proj_heads = attention._proj_heads

    def recorded_proj_heads(x, w):
        g = gathers[phase[-1]] if phase else None
        marks = (len(g.shapes), len(g.permutes)) if g else (0, 0)
        out = proj_heads(x, w)
        if g and sh.is_dtensor(w) and w.shape[1] == cfg.n_kv_heads != cfg.n_heads:
            kv_proj[phase[-1]].append(
                [["P" if p.is_partial() else str(p) for p in out.placements],
                 list(w.to_local().reshape(w.to_local().shape[0], -1).shape),
                 [[a, s] for a, s in zip(g.axes[marks[0]:], g.shapes[marks[0]:])],
                 g.permutes[marks[1]:]])
        return out

    moe.einsum, mamba2.ssd_chunked = recorded_einsum, recorded_ssd
    attention._proj_heads = recorded_proj_heads

    out = {}
    mesh = meshes[4]
    _, Replicate, Shard = sh.placement_types()
    gen = torch.Generator().manual_seed(5)
    q, kc, vc = (torch.randn(shape, generator=gen) for shape in
                 ((3, 8, 16), (3, 2, 6, 16), (3, 2, 6, 16)))
    lens = torch.tensor([6, 3, 0], dtype=torch.int32)  # blocks 2, 2, 2, 0; one row of length 0
    want = ops.decode_attention(q, kc, vc, lens)
    seq = (Replicate(), Shard(2))
    with Gathers() as g:
        got = full(ops.decode_attention(
            sh.distribute_as(q, mesh, (Replicate(), Shard(1))), sh.distribute_as(kc, mesh, seq),
            sh.distribute_as(vc, mesh, seq), lens))
    uneven = {"decode": (got[:2] - want[:2]).abs().max().item(),
              "decode_empty_row": got[2].abs().max().item(), "decode_gathers": g.shapes,
              "cache_block": list(kc[:, :, :2].shape)}
    for causal, sk in ((True, 7), (False, 5)):
        q, k, v = (torch.randn(shape, generator=gen) for shape in
                   ((2, 7, 4, 16), (2, sk, 2, 16), (2, sk, 2, 16)))
        want = ops.flash_attention(q, k, v, causal=causal)
        with Gathers() as g:
            got = ops.flash_attention(sh.distribute_as(q, mesh, (Replicate(), Shard(1))), k, v,
                                      causal=causal)
        uneven[f"flash_{causal}"] = (full(got) - want).abs().max().item()
        uneven[f"flash_{causal}_gathers"] = g.shapes
    out["uneven"] = uneven

    for name, (arch, model, quant, steps) in cases.items():
        mesh = meshes[model]
        cfg = get_config(arch, reduced=True).replace(
            dtype=torch.float32, kv_quant=quant,
            sharding_overrides=get_config(arch).sharding_overrides, **variants.get(name, {}))
        if cfg.family == "encdec":
            cfg = cfg.replace(n_frontend_tokens=n_frames)
        rules = make_rules(cfg, mesh)
        flat = np.load(f"{tmp}/{name if name in variants else arch}.npz")
        tree = {}
        for key in flat.files:
            node = tree
            *path, leaf = key.split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = flat[key]
        plain = bridge.params_from_numpy(tree, device="cpu")
        toks = torch.from_numpy(np.load(f"{tmp}/tokens.npy"))
        frames = (torch.from_numpy(np.load(f"{tmp}/frames.npy")),) if cfg.family == "encdec" else ()
        gathers = {"prefill": Gathers(), "decode": Gathers()}

        def run(params, caches, toks, frames, rules):
            step = (lambda fn: fn) if rules is None else (lambda fn: _with_rules(rules, fn))
            phase[:] = ["prefill"]
            with gathers["prefill"]:
                logits, caches = step(TF.prefill_logits)(cfg, params, toks, caches, *frames)
            out, snaps = [full(logits).tolist()], [gathered(caches)]
            phase[:] = ["decode"]
            for _ in range(steps):
                nxt = logits.argmax(-1).to(torch.int32)
                with gathers["decode"]:
                    logits, caches = step(TF.decode_logits)(cfg, params, nxt, caches)
                out.append(full(logits).tolist())
            snaps.append(gathered(caches))
            phase.clear()
            return out, snaps

        caches = TF.init_caches(cfg, batch, max_seq, device="cpu")
        rec = {}
        rec["plain"], plain_snaps = run(plain, caches, toks, frames, None)
        for g in gathers.values():
            g.shapes.clear()
            g.axes.clear()
            g.permutes.clear()
        for v in kv_proj.values():
            v.clear()
        products.clear()
        ssd_x.clear()
        caches = TF.init_caches(cfg, batch, max_seq, device="cpu")
        specs = sh.specs_for_axes(caches, TF.cache_axes(cfg), rules)
        caches = sh.map_pair(lambda t, s: sh.distribute(t, s, mesh), caches, specs)
        with sh.use_sharding_rules(rules):
            rec.update(seq_sharded=sh.seq_sharded(), caches=placed(caches))
        params = sh.distribute_tree(plain, TF.param_template(cfg), rules)
        rec["attn"] = placed(params["layers"].get("attn", {}))
        rec["blocks"] = {k: list(v.to_local().shape) for k, v in tree_items(caches)}
        frames = tuple(sh.distribute(f, rules.spec_for_shape(tuple(f.shape), ("batch", "seq", None)),
                                     mesh) for f in frames)
        toks = sh.distribute(toks, rules.spec_for_shape(tuple(toks.shape), ("batch", "seq")), mesh)
        rec["tokens_block"] = list(toks.to_local().shape)
        rec["logits"], snaps = run(params, caches, toks, frames, rules)
        rec["gathers"] = {k: g.shapes for k, g in gathers.items()}
        rec["gather_axes"] = {k: g.axes for k, g in gathers.items()}
        rec["products"], rec["ssd_x"] = products[:], ssd_x[:]
        rec["kv_proj"] = {k: v[:] for k, v in kv_proj.items()}
        rec["permutes"] = {k: g.permutes for k, g in gathers.items()}
        if rank == 0:
            for i, (snap, plain_snap) in enumerate(zip(snaps, plain_snaps)):
                np.savez(f"{tmp}/{name}_cache{i}.npz", **snap)
                np.savez(f"{tmp}/{name}_plain_cache{i}.npz", **plain_snap)
        out[name] = rec
    if rank == 0:
        with open(f"{tmp}/out.json", "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
""")


@contextlib.contextmanager
def _jax_logits_recorded(monkeypatch):
    """Record every logits array the JAX model masks (its prefill's and each
    decode step's), op by op (tests/test_torch_kvquant.py)."""
    seen = []
    mask = JL.vocab_mask_logits

    def recording(logits, cfg):
        out = mask(logits, cfg)
        seen.append(np.asarray(out.astype(jnp.float32)))
        return out

    monkeypatch.setattr(JL, "vocab_mask_logits", recording)
    with jax.disable_jit():
        yield seen


def _flat(tree, path=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{path}{k}/") if isinstance(v, dict) else {f"{path}{k}": np.asarray(v)})
    return out


def _jax_cfg(name):
    arch = CASES[name][0] if name in CASES else name
    jcfg = jax_get_config(arch, reduced=True).replace(dtype=jnp.float32, **VARIANTS.get(name, {}))
    return jcfg.replace(n_frontend_tokens=FRAMES) if jcfg.family == "encdec" else jcfg


def _params_key(name):
    """The name of a case's parameters: its arch's, or its own for a variant."""
    return name if name in VARIANTS else CASES[name][0]


def _jax_run(name, quant, steps, params, toks, frames):
    """JAX's prefill and decode steps: (masked logits of every pass, token
    ids of every pass, cache leaves after the prefill and after the last
    step)."""
    jcfg = _jax_cfg(name).replace(kv_quant=quant)
    extra = (jnp.asarray(frames),) if jcfg.family == "encdec" else ()
    with pytest.MonkeyPatch.context() as mp, _jax_logits_recorded(mp) as logits:
        nxt, jc = JTF.prefill(jcfg, params, jnp.asarray(toks), JTF.init_caches(jcfg, BATCH, MAX_SEQ),
                              *extra)
        ids, snaps = [np.asarray(nxt)], [_flat(jc)]
        for _ in range(steps):
            nxt, jc = JTF.decode_step(jcfg, params, nxt, jc)
            ids.append(np.asarray(nxt))
        snaps.append(_flat(jc))
    return logits, ids, snaps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' logits, cache placements and cache snapshots beside
    JAX's run of each case, which the parent makes while the workers run."""
    tmp = tmp_path_factory.mktemp("mesh_serve")
    jparams = {}
    for name in CASES:
        key = _params_key(name)
        if key not in jparams:
            jparams[key] = JTF.init_params(jax.random.PRNGKey(0), _jax_cfg(name))
            np.savez(tmp / f"{key}.npz", **_flat(jparams[key]))
    vocab = min(jax_get_config(c[0], reduced=True).vocab_size for c in CASES.values())
    toks = np.random.default_rng(3).integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)
    np.save(tmp / "tokens.npy", toks)
    d_model = _jax_cfg("whisper-large-v3").d_model
    frames = (np.random.default_rng(7).standard_normal((BATCH, FRAMES, d_model)) * 0.02
              ).astype(np.float32)
    np.save(tmp / "frames.npy", frames)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    spec = json.dumps([CASES, VARIANTS, BATCH, PROMPT, MAX_SEQ, FRAMES])
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port, str(tmp), spec],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    want = {name: _jax_run(name, quant, steps, jparams[_params_key(name)], toks, frames)
            for name, (_, _, quant, steps) in CASES.items()}
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    with open(tmp / "out.json") as f:
        got = json.load(f)
    return tmp, got, want


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_prefill_and_decode_logits_match(runs, name):
    """Every pass's logits: within 3e-5 of the port's unsharded run, within
    1e-4 of JAX's
    (tests/test_torch_model.py's tolerance for the port's f32 model, whose
    sums run in another order than XLA's), the same token."""
    _, got, want = runs
    jlogits, jids, _ = want[name]
    logits = [np.asarray(x, np.float32) for x in got[name]["logits"]]
    plain = [np.asarray(x, np.float32) for x in got[name]["plain"]]
    assert len(logits) == len(plain) == len(jlogits) == CASES[name][3] + 1
    for t, (g, p, w, ids) in enumerate(zip(logits, plain, jlogits, jids)):
        np.testing.assert_allclose(g, p, **TOL, err_msg=f"pass {t}")
        np.testing.assert_allclose(g, w, **MODEL_TOL, err_msg=f"pass {t}")
        np.testing.assert_array_equal(g.argmax(-1), ids, err_msg=f"pass {t}")


def _assert_cache_close(got, want, tol, where) -> int:
    """Every leaf of ``want``: f32 within ``tol`` of its largest magnitude,
    integers equal, int8 apart by at most 1.  Returns how many int8 entries
    differ."""
    assert set(got.files) == set(want), (sorted(got.files), sorted(want))
    near_half = 0
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype, key
        if w.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max(initial=0) <= 1, f"{key} {where}"
            near_half += int((diff > 0).sum())
        elif w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=f"{key} {where}")
        else:
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, atol=tol["atol"] * scale, rtol=tol["rtol"],
                                       err_msg=f"{key} {where}")
    return near_half


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_caches_match(runs, name):
    """Every cache leaf (the SSM state too) after the prefill and after the
    last step, gathered: against the port's unsharded run at 3e-5 and JAX's
    at 1e-4
    (tests/test_torch_kvquant.py's rule for the f32 leaves)."""
    tmp, _, want = runs
    near_half = 0
    for i, jsnap in enumerate(want[name][2]):
        snap = np.load(tmp / f"{name}_cache{i}.npz")
        plain = np.load(tmp / f"{name}_plain_cache{i}.npz")
        near_half += _assert_cache_close(snap, {k: plain[k] for k in plain.files}, TOL,
                                         f"after pass {i}, against the unsharded port")
        near_half += _assert_cache_close(snap, jsnap, MODEL_TOL, f"after pass {i}, against JAX")
    assert near_half <= 8, near_half


def test_each_case_is_really_sharded(runs):
    """The layouts the cases are meant to exercise are the ones that ran."""
    rec = runs[1]
    cache = {n: rec[n]["caches"]["layers/k"] for n in CASES if "layers/k" in rec[n]["caches"]}
    # q's heads over the 4-way "model" axis, the 2 KV heads whole
    assert rec["granite-8b"]["attn"]["wq"][1] == "S(2)"
    assert rec["granite-8b"]["attn"]["wk"][1] == "R"
    assert cache["granite-8b"] == ["S(1)", "S(3)"]  # cache_seq over "model" ("data" is 1)
    assert cache["granite-8b-int8"] == ["S(1)", "S(3)"]  # + the batch over "data"
    assert rec["granite-8b-int8"]["caches"]["layers/k_scale"] == ["S(1)", "S(3)"]
    assert cache["olmoe-1b-7b"] == ["S(1)", "S(2)"]  # KV heads over "model"
    assert [rec[n]["seq_sharded"] for n in CASES] == [False, False, True, False, True, True,
                                                      False, False, False, False, False]
    assert cache["grok-1-314b"] == ["S(1)", "S(3)"]  # cache_seq over "model"
    # the SSM state's heads over "model" (its batch over "data")
    for n in SSM_CASES:
        assert rec[n]["caches"]["layers/h"] == ["S(1)", "S(2)"]
    assert rec["zamba2-2.7b"]["caches"]["shared/k"] == ["S(1)", "S(2)"]  # KV heads over "model"
    # q's 2 heads over "model", the one KV head whole there; d_model over "data" (FSDP)
    for name in ("nemotron-4-340b-kv1", "nemotron-4-340b-kv1-int8"):
        kv1 = rec[name]["attn"]
        assert kv1["wq"] == ["S(1)", "S(2)"] and kv1["wk"] == kv1["wv"] == ["S(1)", "R"]
        assert cache[name] == ["S(1)", "S(3)"]
    assert rec["nemotron-4-340b-kv1-int8"]["caches"]["layers/k_scale"] == ["S(1)", "S(3)"]
    # the latent cache: the batch over "data", the sequence over "model"
    for leaf in ("layers/ckv", "layers/krope"):
        assert rec["minicpm3-4b"]["caches"][leaf] == ["S(1)", "S(2)"]
    # the cross cache's frames over "model" beside the self cache's sequence
    assert rec["whisper-large-v3"]["caches"]["cross/k"] == ["S(1)", "S(3)"]
    assert rec["whisper-large-v3"]["caches"]["layers/k"] == ["S(1)", "S(3)"]


# olmoe's and zamba2's caches: KV heads over "model"; mamba2 has no KV cache
SEQ_CACHE = [n for n in CASES if n not in ("olmoe-1b-7b", *SSM_CASES)]


@pytest.mark.parametrize("name", SEQ_CACHE)
def test_decode_keeps_the_cache_sequence_shard(runs, name):
    """No decode step all-gathers a block of a cache leaf (K, V, their int8
    scales; whisper's cross cache too; MLA's ckv and krope) or, under MLA,
    a (B, H, S_loc) score block: each rank reads its own slice, and what
    the step gathers are q and the slices' (out, lse) partials, one a
    layer a step (ctx and lse, kv_lora_rank + 1 wide, under MLA)."""
    rec = runs[1][name]
    cfg = _config(name)
    mla = cfg.attn == "mla"
    blocks = {k: v for k, v in rec["blocks"].items() if k.split("/")[-1] != "lengths"}
    seq = 2 if mla else 3  # the sequence's dim in a stacked (L, B, ...) leaf
    assert all(v[seq] < MAX_SEQ for k, v in blocks.items() if k.startswith("layers/")), blocks
    cache_shapes = [v for v in blocks.values()] + [v[1:] for v in blocks.values()]
    if mla:
        b, s = blocks["layers/ckv"][1:3]
        cache_shapes.append([b, cfg.n_heads, s])  # a score block
    decode = rec["gathers"]["decode"]
    assert not [s for s in decode if s in cache_shapes], (decode, cache_shapes)
    width = cfg.kv_lora_rank if mla else blocks["layers/k"][-1]
    partials = [s for s in decode if s[0] == 1 and s[-1] == width + 1]
    calls = CASES[name][3] * cfg.n_layers * (2 if name.startswith("whisper") else 1)
    assert len(partials) == calls, (partials, calls)


@pytest.mark.parametrize("name", ["qwen1.5-4b", "whisper-large-v3"])
def test_seq_parallel_prefill_keeps_q_local(runs, name):
    """Under sequence parallelism the prefill gathers k and v of each
    attention (self, the encoder's, the cross-attention's), not q: the
    operands of q's sequence-block shape number two an attention."""
    rec = runs[1][name]
    cfg = _config(name)
    b, s = rec["tokens_block"]
    assert s < PROMPT
    q_block = [b, s, cfg.n_heads, cfg.resolved_head_dim]
    attns = cfg.n_layers + (cfg.n_layers + cfg.n_enc_layers if cfg.family == "encdec" else 0)
    assert rec["gathers"]["prefill"].count(q_block) == 2 * attns, rec["gathers"]["prefill"]


def _config(name):
    return jax_get_config(CASES[name][0], reduced=True).replace(**VARIANTS.get(name, {}))


def test_uneven_and_empty_sequence_blocks(runs):
    """The ops on blocks placed by hand over the 4-way axis: decode over 6
    cache rows (blocks 2, 2, 2, 0; lengths 6, 3 and 0), and the flash
    forward over 7 query rows (2, 2, 2, 1) causal and across 5 keys, each
    within 3e-5 of its unsharded call; the row of length 0 gives 0, as the
    kernel does (the unsharded plain oracle averages V there); no cache
    block and no q block is gathered."""
    u = runs[1]["uneven"]
    assert u["decode"] <= 3e-5 and u["decode_empty_row"] == 0
    assert u["cache_block"] not in u["decode_gathers"], u["decode_gathers"]
    for causal in (True, False):
        assert u[f"flash_{causal}"] <= 3e-5
        assert u[f"flash_{causal}_gathers"] == []


@pytest.mark.parametrize("name", list(MOE_CONTRACTED))
def test_moe_product_contracts_its_sharded_index_on_blocks(runs, name):
    """grok-1's down projection (d_ff over "model") and olmoe's combine (the
    experts over "model") run on each rank's blocks in the prefill and every
    decode step: one call a layer a pass, its output partial over "model"
    (reduced where the next op reads it), and no all-gather over "model" of
    an operand's block (hidden and w_down; combine and out_buf)."""
    rec = runs[1][name]
    calls = [c for c in rec["products"] if c[0] == MOE_CONTRACTED[name]]
    assert len(calls) == _config(name).n_layers * (CASES[name][3] + 1), rec["products"]
    model_gathers = [s for k in ("prefill", "decode")
                     for s, a in zip(rec["gathers"][k], rec["gather_axes"][k]) if a == "model"]
    for _, placements, blocks in calls:
        assert placements[1] == "P", placements
        assert not [s for s in model_gathers if s in blocks], (blocks, model_gathers)


@pytest.mark.parametrize("name", SSM_CASES)
def test_ssd_scans_each_rank_heads(runs, name):
    """The sharded SSM mixer keeps the reference's head shard: each prefill
    layer's SSD scan runs on the rank's H / "model" heads (x's block), and
    no all-gather over "model" takes a block of the gated norm's input (y,
    its rows split over the heads: one all-reduce of its statistic)."""
    rec = runs[1][name]
    cfg = _config(name)
    model = CASES[name][1]
    assert len(rec["ssd_x"]) == cfg.n_layers, rec["ssd_x"]
    b, s = rec["tokens_block"]
    assert all(x[0] == b and x[2] == cfg.ssm_nheads // model for x in rec["ssd_x"]), rec["ssd_x"]
    y_block = [b, s, cfg.ssm_expand * cfg.d_model // model]
    model_gathers = [g for g, a in zip(rec["gathers"]["prefill"], rec["gather_axes"]["prefill"])
                     if a == "model"]
    assert y_block not in model_gathers, model_gathers


@pytest.mark.parametrize("name", ["nemotron-4-340b-kv1", "nemotron-4-340b-kv1-int8"])
def test_decode_contracts_kv_projections_over_the_idle_axis(runs, name):
    """nemotron's variant on (2, 2), with the f32 and the int8 cache (k and
    v cast back before RoPE and the append): in every decode step and in
    the prefill the wk and wv products (one each a layer) come out
    ``Partial`` over "model", each after one permute over "data" of w's
    block (d_model / 2 x KV * hd) and no all-gather of it.  The prefill's
    12 rows a rank are fewer than K = 20, and the reference's compiled
    prefill of this variant on (2, 2) contracts there too: it permutes
    f32[10,1,10] blocks of wk and wv and all-reduces their (2, 6, 1, 10)
    partials.  No other product of either pass permutes.  The logits and
    caches of these passes are held to the unsharded run and to JAX by the
    tests above."""
    rec = runs[1][name]
    cfg = _config(name)
    w_block = [cfg.d_model // 2, cfg.n_kv_heads * cfg.resolved_head_dim]
    prefill, decode = rec["kv_proj"]["prefill"], rec["kv_proj"]["decode"]
    assert len(prefill) == 2 * cfg.n_layers and len(decode) == 2 * cfg.n_layers * CASES[name][3]
    for placements, block, gathers, permutes in decode + prefill:
        assert placements[1] == "P" and block == w_block, (placements, block)
        assert permutes == [["data", w_block]] and gathers == [], (permutes, gathers)
    for phase, calls in (("prefill", prefill), ("decode", decode)):
        assert len(rec["permutes"][phase]) == len(calls), rec["permutes"][phase]
