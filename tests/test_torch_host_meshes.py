"""The port's sharded serving on small ("data", "model") host meshes against
the reference's, live.

One subprocess compiles the reference's decode step (``repro.launch.steps``
``build_decode_artifacts``, jitted on XLA host devices) of a model with one
KV head, 4 q heads and d_model 96, with and without the FSDP overlay
(d_model over "data"), on every mesh below, and reads its dot FLOPs a
device (``repro.launch.hlo_analysis``).  Another counts the port's decode
step of the same shapes (``repro_torch.launch.dryrun._count`` on a fake
process group of the mesh's ranks).  The two agree within 0.98-1.02:

- "model" a multiple of "data", (2, 2), (4, 4), (2, 4), (2, 8), (4, 8):
  under the FSDP overlay the reference contracts wk and wv (and on an 8-way
  axis, where 4 q heads do not divide it, wq) over "model" on K / m slices
  of the FSDP blocks, up to K - 1 rows a rank (checked at 48, 95 and 96
  rows on (2, 4)); "model" smaller than "data", (4, 2), (8, 2), gathers;
- a one-way "model" axis, (1, 1), (2, 1), (4, 1), and (1, 2): one KV head
  on a 1-way axis, which the port could not run until its placements left
  a size-1 dim whole.

On 8 gloo processes the values: ``sharding.matmul`` on (2, 4) and (4, 2)
(output and x, w gradients within 3e-5 of the unsharded product; on (2, 4)
one K / 4 slice permuted and no block of w gathered, on (4, 2) w gathered),
and a prefill of 4 prompts and 2 decode steps of the FSDP variant on
(2, 4), (4, 2) and (2, 1) (ranks 0 and 1), logits and caches within 3e-5 of
the port's unsharded run; the (2, 1) run also within 1e-4 of JAX's
(tests/test_torch_mesh_serve.py's tolerances).
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
WORLD = 8
TOL = dict(rtol=3e-5, atol=3e-5)  # tests/test_kernels.py's f32 tolerance
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_model.py's f32 model tolerance
KV1 = {"n_kv_heads": 1, "n_heads": 4, "d_model": 96}  # head dim 24
FSDP = {"d_model": ["data"]}

# name -> (arch, "data", "model", rows a "data" rank, FSDP overlay)
C8 = [(2, 2), (4, 4), (2, 4), (2, 8), (4, 8), (4, 2), (8, 2)]
C9 = [(1, 1), (1, 2), (2, 1), (4, 1)]
SPECS = {}
for _d, _m in C8:
    SPECS[f"nemotron-fsdp-{_d}x{_m}"] = ("nemotron-4-340b", _d, _m, 1, True)
    SPECS[f"nemotron-{_d}x{_m}"] = ("nemotron-4-340b", _d, _m, 1, False)
for _rows in (48, 95, 96):  # K / n, K - 1 and K rows a rank
    SPECS[f"nemotron-fsdp-2x4-rows{_rows}"] = ("nemotron-4-340b", 2, 4, _rows, True)
for _d, _m in C9:
    SPECS[f"nemotron-fsdp-{_d}x{_m}-rows2"] = ("nemotron-4-340b", _d, _m, 2, True)
    SPECS[f"nemotron-{_d}x{_m}-rows2"] = ("nemotron-4-340b", _d, _m, 2, False)
    SPECS[f"granite-{_d}x{_m}-rows2"] = ("granite-8b", _d, _m, 2, False)

REF_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=32"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import ShapeSpec, get_config
    from repro.launch import steps
    from repro.launch.hlo_analysis import analyze

    specs, fields, fsdp = json.loads(sys.argv[1])
    out = {}
    for name, (arch, d, m, rows, overlay) in specs.items():
        cfg = get_config(arch, reduced=True).replace(
            dtype=jnp.float32, sharding_overrides={k: tuple(v) for k, v in fsdp.items()}
            if overlay else None, **fields)
        mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m), ("data", "model"))
        art = steps.build_decode_artifacts(cfg, ShapeSpec("decode", 64, rows * d, "decode"),
                                           steps.make_rules(cfg, mesh))
        with mesh:
            compiled = jax.jit(art.fn, in_shardings=art.in_shardings,
                               out_shardings=art.out_shardings,
                               donate_argnums=art.donate).lower(*art.args).compile()
        rep = analyze(compiled.as_text())
        out[name] = [rep.dot_flops, rep.coll_count.get("collective-permute", 0)]
    print(json.dumps(out))
""")

PORT_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import fake_process_group, make_host_mesh

    specs, fields, fsdp = json.loads(sys.argv[1])
    out = {}
    for name, (arch, d, m, rows, overlay) in specs.items():
        cfg = get_config(arch, reduced=True).replace(
            dtype=torch.float32, sharding_overrides={k: tuple(v) for k, v in fsdp.items()}
            if overlay else None, **fields)
        with fake_process_group(d * m):
            mesh = make_host_mesh(model=m)
            art = steps.build_decode_artifacts(cfg, ShapeSpec("decode", 64, rows * d, "decode"),
                                               steps.make_rules(cfg, mesh))
            try:
                out[name] = dryrun._count(art, mesh, grad=False)["flops"]
            except Exception as e:  # a case that fails is recorded, and fails its test
                out[name] = f"{type(e).__name__}: {e}"[:400]
    print(json.dumps(out))
""")

BATCH, PROMPT, MAX_SEQ, STEPS = 4, 6, 16, 2
# name -> (mesh, (x shape, x's sharded dims by axis), (w shape, w's), the
# output's placements): w's rows FSDP blocks over "data", K = 16
MATMULS = {
    # 2 rows a rank, fewer than K: K contracted over "model" in slices of 4
    "2x4-few-rows": ("2x4", [(4, 1, 16), {"data": 0}], [(16, 6), {"data": 0}], ["S(0)", "P"]),
    # 16 rows a rank, K: w gathered over "data", the whole product
    "2x4-many-rows": ("2x4", [(32, 16), {"data": 0}], [(16, 6), {"data": 0}], ["S(0)", "R"]),
    # "model" smaller than "data": w gathered
    "4x2-few-rows": ("4x2", [(4, 1, 16), {"data": 0}], [(16, 6), {"data": 0}], ["S(0)", "R"]),
}
SERVE = ("2x4", "4x2", "2x1")

WORKER = textwrap.dedent("""
    import json, sys

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils._python_dispatch import TorchDispatchMode

    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.steps import _with_rules, make_rules
    from repro_torch.models import attention, bridge
    from repro_torch.models import transformer as TF

    rank, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    matmuls, serve, fields, fsdp, batch, max_seq, steps = json.loads(sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=8)
    names = ("data", "model")
    meshes = {"2x4": init_device_mesh("cpu", (2, 4), mesh_dim_names=names),
              "4x2": init_device_mesh("cpu", (4, 2), mesh_dim_names=names),
              "2x1": DeviceMesh("cpu", torch.arange(2).reshape(2, 1), mesh_dim_names=names)}
    mine = {k: m for k, m in meshes.items() if m.get_coordinate() is not None}
    axis_of = {m.get_group(i).group_name: n for m in mine.values() for i, n in enumerate(names)}
    data = np.load(f"{tmp}/inputs.npz")

    class Comms(TorchDispatchMode):
        # the mesh axis and local operand shape of each all-gather and of
        # each all_to_all_single (a permute) issued below DTensor

        def __init__(self):
            super().__init__()
            self.gathers, self.permutes = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func.namespace == "_c10d_functional" and func.__name__.startswith("all_gather"):
                self.gathers.append([axis_of[args[2]], list(args[0].shape)])
            if func.namespace == "_c10d_functional" and func.__name__.startswith("all_to_all"):
                self.permutes.append([axis_of[args[3]], list(args[0].shape)])
            return func(*args, **(kwargs or {}))

    def pl_str(t):
        return ["P" if p.is_partial() else "R" if p.is_replicate() else f"S({p.dim})"
                for p in t.placements]

    def placed(mesh, name, dims):
        pl = [Shard(dims[a]) if a in dims else Replicate() for a in names]
        return sh.distribute_as(torch.from_numpy(data[name]), mesh, pl).requires_grad_(True)

    out, saved = {}, {}
    for name, (mesh_name, xs, ws, _) in matmuls.items():
        mesh = meshes[mesh_name]
        x, w = placed(mesh, f"{name}_x", xs[1]), placed(mesh, f"{name}_w", ws[1])
        with Comms() as fwd:
            y = sh.matmul(x, w)
        with Comms() as bwd:
            whole = y.redistribute(mesh, [Replicate()] * 2).to_local()
            (whole * torch.from_numpy(data[f"{name}_cot"])).sum().backward()
        out[name] = {"placements": pl_str(y), "dtype": str(y.dtype), "gathers": fwd.gathers,
                     "permutes": fwd.permutes, "bwd_permutes": bwd.permutes,
                     "w_block": list(w.to_local().shape)}
        saved.update({f"{name}_out": whole.detach().numpy(),
                      f"{name}_grad_x": x.grad.full_tensor().numpy(),
                      f"{name}_grad_w": w.grad.full_tensor().numpy()})

    cfg = get_config("nemotron-4-340b", reduced=True).replace(
        dtype=torch.float32, sharding_overrides={k: tuple(v) for k, v in fsdp.items()}, **fields)
    flat = np.load(f"{tmp}/params.npz")
    tree = {}
    for key in flat.files:
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = flat[key]
    plain = bridge.params_from_numpy(tree, device="cpu")
    tokens = torch.from_numpy(np.load(f"{tmp}/tokens.npy"))

    kv_proj, phase = [], []
    proj_heads = attention._proj_heads

    def recorded_proj_heads(x, w):
        # the sharded K/V projections: pass, output placements, w's block,
        # and the gathers and permutes issued inside the product
        if not (phase and sh.is_dtensor(w) and w.shape[1] == cfg.n_kv_heads):
            return proj_heads(x, w)
        with Comms() as c:
            y = proj_heads(x, w)
        wl = w.to_local()
        kv_proj.append([phase[0], pl_str(y), [wl.shape[0], wl.shape[1] * wl.shape[2]],
                        c.gathers, c.permutes])
        return y

    attention._proj_heads = recorded_proj_heads

    def full(t):
        return t.full_tensor() if sh.is_dtensor(t) else t

    def snapshot(tree, path=""):
        got = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                got.update(snapshot(v, f"{path}{k}/"))
            else:
                got[f"{path}{k}"] = full(v).numpy().copy()  # the plain run writes in place
        return got

    def run(params, caches, toks, rules):
        step = (lambda fn: fn) if rules is None else (lambda fn: _with_rules(rules, fn))
        phase[:] = ["prefill"] if rules is not None else []
        logits, caches = step(TF.prefill_logits)(cfg, params, toks, caches)
        logits_all = [full(logits).tolist()]
        for _ in range(steps):
            phase[:] = ["decode"] if rules is not None else []
            nxt = full(logits).argmax(-1).to(torch.int32)
            logits, caches = step(TF.decode_logits)(cfg, params, nxt, caches)
            logits_all.append(full(logits).tolist())
        phase.clear()
        return logits_all, snapshot(caches)

    plain_logits, plain_cache = run(plain, TF.init_caches(cfg, batch, max_seq, device="cpu"),
                                    tokens, None)
    for mesh_name in serve:
        if mesh_name not in mine:
            continue
        mesh = mine[mesh_name]
        rules = make_rules(cfg, mesh)
        caches = TF.init_caches(cfg, batch, max_seq, device="cpu")
        specs = sh.specs_for_axes(caches, TF.cache_axes(cfg), rules)
        caches = sh.map_pair(lambda t, s: sh.distribute(t, s, mesh), caches, specs)
        params = sh.distribute_tree(plain, TF.param_template(cfg), rules)
        toks = sh.distribute(tokens, rules.spec_for_shape(tuple(tokens.shape), ("batch", "seq")),
                             mesh)
        kv_proj.clear()
        logits, cache = run(params, caches, toks, rules)
        out[mesh_name] = {"logits": logits, "plain": plain_logits, "kv_proj": kv_proj[:],
                          "wk": pl_str(params["layers"]["attn"]["wk"])}
        if rank == 0:
            np.savez(f"{tmp}/{mesh_name}_cache.npz", **cache)
    if rank == 0:
        np.savez(f"{tmp}/plain_cache.npz", **plain_cache)
        np.savez(f"{tmp}/outputs.npz", **saved)
        with open(f"{tmp}/out.json", "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
""")


@contextlib.contextmanager
def _jax_logits_recorded(monkeypatch):
    """Record every logits array the JAX model masks (its prefill's and each
    decode step's), op by op (tests/test_torch_mesh_serve.py)."""
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


def _spawn(script, *args):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-c", script, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(p, what, timeout=420) -> str:
    out, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, f"{what} failed:\n{err.decode()[-3000:]}"
    return out.decode()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's dot FLOPs of every spec, the gloo
    workers' values and layouts, and JAX's prefill and decode steps."""
    tmp = tmp_path_factory.mktemp("host_meshes")
    spec = json.dumps([SPECS, KV1, FSDP])
    ref = _spawn(REF_SCRIPT, spec)
    port = _spawn(PORT_SCRIPT, spec)
    rng = np.random.default_rng(31)
    inputs = {}
    for name, (_, xs, ws, _) in MATMULS.items():
        inputs[f"{name}_x"] = rng.standard_normal(xs[0]).astype(np.float32)
        inputs[f"{name}_w"] = rng.standard_normal(ws[0]).astype(np.float32)
        inputs[f"{name}_cot"] = rng.standard_normal((*xs[0][:-1], ws[0][1])).astype(np.float32)
    np.savez(tmp / "inputs.npz", **inputs)
    jcfg = jax_get_config("nemotron-4-340b", reduced=True).replace(dtype=jnp.float32, **KV1)
    jparams = JTF.init_params(jax.random.PRNGKey(0), jcfg)
    np.savez(tmp / "params.npz", **_flat(jparams))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    np.save(tmp / "tokens.npy", toks)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        gloo_port = str(s.getsockname()[1])
    wspec = json.dumps([MATMULS, SERVE, KV1, FSDP, BATCH, MAX_SEQ, STEPS])
    workers = [_spawn(WORKER, str(r), gloo_port, str(tmp), wspec) for r in range(WORLD)]
    with pytest.MonkeyPatch.context() as mp, _jax_logits_recorded(mp) as jlogits:
        nxt, jc = JTF.prefill(jcfg, jparams, jnp.asarray(toks),
                              JTF.init_caches(jcfg, BATCH, MAX_SEQ))
        for _ in range(STEPS):
            nxt, jc = JTF.decode_step(jcfg, jparams, nxt, jc)
    jax_run = (jlogits, _flat(jc))
    for r, p in enumerate(workers):
        _finish(p, f"rank {r}")
    flops = {"ref": json.loads(_finish(ref, "the reference's compile").splitlines()[-1]),
             "port": json.loads(_finish(port, "the port's count").splitlines()[-1])}
    got = json.loads((tmp / "out.json").read_text())
    return tmp, flops, got, inputs, jax_run


@pytest.mark.parametrize("name", list(SPECS))
def test_decode_dot_flops_a_device_match_the_reference(runs, name):
    """The port's decode step runs on the mesh (one KV head on a 1-way
    "model" axis included) and does the reference's dot FLOPs a device,
    within 0.98-1.02."""
    ref, got = runs[1]["ref"][name][0], runs[1]["port"][name]
    assert not isinstance(got, str), got
    assert 0.98 * ref <= got <= 1.02 * ref, (got, ref, got / ref)


def test_the_reference_contracts_where_model_is_a_multiple_of_data(runs):
    """The reference's programs that the rule follows: under the FSDP
    overlay, collective-permutes on every mesh whose "model" axis is a
    multiple of "data", and at most one (an s32 index) where it is smaller;
    K rows a rank cost what the whole product costs a row, K - 1 what the
    contraction does."""
    ref = runs[1]["ref"]
    for d, m in C8:
        permutes = ref[f"nemotron-fsdp-{d}x{m}"][1]
        assert (permutes >= 4) if m % d == 0 else (permutes <= 1), (d, m, permutes)
    per_row = {r: ref[f"nemotron-fsdp-2x4-rows{r}"][0] / r for r in (48, 95, 96)}
    assert per_row[48] == pytest.approx(per_row[95], rel=1e-3)
    assert per_row[96] > 1.1 * per_row[95], per_row


@pytest.mark.parametrize("name", list(MATMULS))
def test_matmul_on_unequal_meshes(runs, name):
    """``sharding.matmul`` on 8 gloo ranks: output and x, w gradients within
    3e-5 of the unsharded product.  On (2, 4) with 2 rows a rank the output
    is an f32 ``Partial`` over "model" after one permute over "data" of a K
    / 4 slice of w's FSDP block, its gradient sent back the same way, and
    no block of w gathered; with K rows a rank, and on (4, 2), w's block is
    gathered over "data" and nothing permuted."""
    tmp, _, got, inputs, _ = runs
    saved = np.load(tmp / "outputs.npz")
    rec, want_pl = got[name], MATMULS[name][3]
    x = torch.from_numpy(inputs[f"{name}_x"]).requires_grad_(True)
    w = torch.from_numpy(inputs[f"{name}_w"]).requires_grad_(True)
    want = x @ w
    (want * torch.from_numpy(inputs[f"{name}_cot"])).sum().backward()
    np.testing.assert_allclose(saved[f"{name}_out"], want.detach().numpy(), **TOL)
    np.testing.assert_allclose(saved[f"{name}_grad_x"], x.grad.numpy(), **TOL)
    np.testing.assert_allclose(saved[f"{name}_grad_w"], w.grad.numpy(), **TOL)
    assert rec["placements"] == want_pl, rec
    w_block = rec["w_block"]
    w_gathers = [a for a, s in rec["gathers"] if s == w_block]
    if want_pl[1] == "P":
        k, cols = inputs[f"{name}_w"].shape
        slice_ = [k // 4, cols]
        assert rec["dtype"] == "torch.float32"
        assert rec["permutes"] == [["data", slice_]] and rec["bwd_permutes"] == [["data", slice_]]
        assert w_gathers == [], rec
    else:
        assert rec["permutes"] == [] and w_gathers == ["data"], rec


@pytest.mark.parametrize("mesh", SERVE)
def test_sharded_serving_matches_the_unsharded_port(runs, mesh):
    """The FSDP variant's prefill and 2 decode steps on (2, 4), (4, 2) and
    (2, 1): every pass's logits and every cache leaf within 3e-5 of the
    port's unsharded run, the same tokens."""
    tmp, _, got, _, _ = runs
    rec = got[mesh]
    for t, (g, p) in enumerate(zip(rec["logits"], rec["plain"])):
        g, p = np.asarray(g, np.float32), np.asarray(p, np.float32)
        np.testing.assert_allclose(g, p, **TOL, err_msg=f"pass {t}")
        np.testing.assert_array_equal(g.argmax(-1), p.argmax(-1), err_msg=f"pass {t}")
    cache, plain = np.load(tmp / f"{mesh}_cache.npz"), np.load(tmp / "plain_cache.npz")
    assert set(cache.files) == set(plain.files)
    for key in plain.files:
        scale = max(1.0, float(np.abs(plain[key]).max()))
        np.testing.assert_allclose(cache[key], plain[key], rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale, err_msg=key)


@pytest.mark.parametrize("mesh", ["2x4", "4x2"])
def test_kv_projections_on_unequal_meshes(runs, mesh):
    """On (2, 4) every wk and wv product of the prefill (12 rows a rank)
    and of each decode step (2) is ``Partial`` over "model" after one
    permute over "data" of a K / 4 = 24-row slice of its (48, 24) FSDP
    block, and gathers no block of w; on (4, 2) each gathers its (24, 24)
    block over "data", permutes nothing and is whole on each "model"
    rank."""
    rec = runs[2][mesh]
    cfg = jax_get_config("nemotron-4-340b", reduced=True).replace(**KV1)
    calls = rec["kv_proj"]
    assert len(calls) == 2 * cfg.n_layers * (1 + STEPS), calls
    assert rec["wk"] == ["S(1)", "R"]  # the stacked (L, d_model, KV, hd) leaf
    n = int(mesh[0])
    block = [cfg.d_model // n, cfg.n_kv_heads * cfg.resolved_head_dim]
    for phase, placements, w_block, gathers, permutes in calls:
        assert w_block == block, (phase, w_block)
        if mesh == "2x4":
            assert placements[1] == "P" and gathers == [], (phase, placements, gathers)
            assert permutes == [["data", [cfg.d_model // 4, block[1]]]], (phase, permutes)
        else:
            assert placements[1] == "R" and permutes == [], (phase, placements, permutes)
            assert gathers == [["data", block]], (phase, gathers)


def test_one_kv_head_on_a_one_way_model_axis_matches_jax(runs):
    """The FSDP variant on (2, 1), its one KV head over the 1-way "model"
    axis: every pass's logits within 1e-4 of JAX's (the port's f32 model
    tolerance), the same tokens, and every cache leaf within 1e-4 of JAX's
    relative to its largest magnitude."""
    tmp, _, got, _, (jlogits, jcache) = runs
    logits = got["2x1"]["logits"]
    assert len(logits) == len(jlogits) == STEPS + 1
    for t, (g, w) in enumerate(zip(logits, jlogits)):
        g = np.asarray(g, np.float32)
        np.testing.assert_allclose(g, w, **MODEL_TOL, err_msg=f"pass {t}")
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1), err_msg=f"pass {t}")
    cache = np.load(tmp / "2x1_cache.npz")
    assert set(cache.files) == set(jcache)
    for key, w in jcache.items():
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(cache[key], w, err_msg=key)
        else:
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(cache[key], w, rtol=MODEL_TOL["rtol"],
                                       atol=MODEL_TOL["atol"] * scale, err_msg=key)
