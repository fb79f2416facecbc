"""The port's continuous-batching engine against the JAX engine (granite-8b
REDUCED in f32, where token ids must agree exactly)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import bridge, kvcache  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.serving.engine import InstanceEngine, ServeRequest  # noqa: E402

JCFG = jax_get_config("granite-8b", reduced=True).replace(dtype=jnp.float32)
CFG = get_config("granite-8b", reduced=True).replace(dtype=torch.float32)


@pytest.fixture(scope="module")
def weights():
    jparams = JTF.init_params(jax.random.PRNGKey(0), JCFG)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, params


def _prompts(n):
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG.vocab_size, size=6 + 2 * (i % 2)).astype(np.int32)
            for i in range(n)]


def _serve(engine, req_cls, prompts, new_tokens):
    for i, p in enumerate(prompts):
        engine.submit(req_cls(i, p, new_tokens[i]))
    done = engine.run_until_done()
    assert len(done) == len(prompts)
    return {r.rid: r.out_tokens for r in done}


def test_engine_matches_jax_engine(weights):
    """More requests than slots (queueing and slot reuse), two prompt lengths
    and staggered finishes."""
    jparams, params = weights
    prompts = _prompts(5)
    new = [4 + (i % 3) for i in range(5)]
    want = _serve(jax_engine.InstanceEngine(JCFG, jparams, n_slots=3, max_seq=48),
                  jax_engine.ServeRequest, prompts, new)
    got = _serve(InstanceEngine(CFG, params, n_slots=3, max_seq=48), ServeRequest, prompts, new)
    assert got == want
    for i, toks in got.items():
        assert len(toks) == new[i] and all(0 <= t < CFG.vocab_size for t in toks)


def test_engine_batched_equals_sequential(weights):
    """Slot interleaving must not change any request's tokens."""
    _, params = weights
    prompts = [np.arange(5, dtype=np.int32) + i for i in range(3)]
    batched = _serve(InstanceEngine(CFG, params, n_slots=3, max_seq=48), ServeRequest,
                     prompts, [5] * 3)
    for i, p in enumerate(prompts):
        eng = InstanceEngine(CFG, params, n_slots=1, max_seq=48)
        eng.submit(ServeRequest(i, p, 5))
        (r,) = eng.run_until_done()
        assert batched[i] == r.out_tokens


def test_free_slot_at_full_length_is_left_alone(weights):
    """A freed slot can hold lengths == max_seq.  Decoding the other slots
    must not index past its cache, write into it or change their tokens."""
    _, params = weights
    prompts, new, max_seq = _prompts(2), [6, 6], 32
    want = _serve(InstanceEngine(CFG, params, n_slots=3, max_seq=max_seq), ServeRequest,
                  prompts, new)
    eng = InstanceEngine(CFG, params, n_slots=3, max_seq=max_seq)
    free = eng.free_slots[0]  # the slot the two requests leave free
    lay = eng.caches["layers"]
    lay["lengths"][:, free] = max_seq
    lay["k"][:, free] = 7.0
    lay["v"][:, free] = -7.0
    before = {k: v[:, free].clone() for k, v in lay.items()}
    assert _serve(eng, ServeRequest, prompts, new) == want
    for k, v in lay.items():
        assert torch.equal(v[:, free], before[k]), k


def test_append_kv_past_the_end_writes_nothing():
    cache = kvcache.init_kv_cache(3, 4, 2, 8, torch.float32, device="cpu")
    cache["lengths"].copy_(torch.tensor([4, 1, 2], dtype=torch.int32))
    k_new = torch.ones(3, 2, 8)
    kvcache.append_kv(cache, k_new, -k_new, live=torch.tensor([True, True, False]))
    assert cache["lengths"].tolist() == [5, 2, 2]  # live rows grow, as in the reference
    assert float(cache["k"][0].abs().sum()) == 0.0  # full row: nothing written
    assert torch.equal(cache["k"][1, :, 1], torch.ones(2, 8))
    assert torch.equal(cache["v"][1, :, 1], -torch.ones(2, 8))
    assert float(cache["k"][2].abs().sum()) == 0.0  # not live: nothing written


def test_live_scaling_gate_and_kv_frac(weights):
    _, params = weights
    eng = InstanceEngine(CFG, params, n_slots=2, max_seq=32)
    assert eng.can_serve_alone()
    eng.set_loaded_layers(1)
    assert not eng.can_serve_alone()
    eng.set_loaded_layers(CFG.n_layers + 3)
    assert eng.can_serve_alone() and eng.loaded_layers == CFG.n_layers
    eng.submit(ServeRequest(0, np.arange(6, dtype=np.int32), 3))
    eng.step()
    assert eng.kv_used_frac() == pytest.approx((6 + 2) / 64)


def test_prefill_only_then_admit_prefilled_matches_local_admission(weights):
    """The disaggregated path: prefill on one engine, admit the 1-slot cache on
    another; decoding continues as if the prefill had been local."""
    _, params = weights
    prompt = _prompts(1)[0]
    want = _serve(InstanceEngine(CFG, params, n_slots=2, max_seq=32), ServeRequest, [prompt], [5])
    src = InstanceEngine(CFG, params, n_slots=2, max_seq=32)
    dst = InstanceEngine(CFG, params, n_slots=2, max_seq=32)
    req = ServeRequest(0, prompt, 5)
    first, one = src.prefill_only(req)
    assert dst.admit_prefilled(req, first, one)
    assert dst.run_until_done() == [req]
    assert req.out_tokens == want[0]
    full = InstanceEngine(CFG, params, n_slots=1, max_seq=32)
    full.submit(ServeRequest(1, prompt, 50))
    full.step()
    assert not full.admit_prefilled(ServeRequest(2, prompt, 5), first, one)
    assert TF.init_caches(CFG, 1, 32, device="cpu")["layers"]["k"].shape == one["layers"]["k"].shape


# ---------------------------------------------------------------------------
# What the captured decode step needs: fixed storage
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, path + (key,)).items()}
    return {path: tree}


@pytest.mark.parametrize("quant", [False, True], ids=["cache", "int8_cache"])
@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b",
                                  "whisper-large-v3", "pixtral-12b", "minicpm3-4b"])
def test_decode_step_under_a_live_mask_keeps_every_cache_leaf_in_place(arch, quant):
    """Every family (dense, MoE, SSM, hybrid, enc-dec, VLM, MLA), with and
    without the int8 cache: three decode steps under a live mask keep every
    cache leaf (the layers' caches or states, scales, the hybrid's shared
    caches, the cross cache) in its storage, the CPU guard of what a CUDA
    graph of the step needs, and leave the rows that are not live as they
    were (an MoE model still appends for a free row: its K/V entry and
    scales at the row's length, or at the batch's largest length in
    lockstep, where no later step of the row reads)."""
    cfg = get_config(arch, reduced=True).replace(dtype=torch.float32, kv_quant=quant)
    params = TF.init_params(cfg, 0, device="cpu")
    b, max_seq = 3, 24
    caches = TF.init_caches(cfg, b, max_seq, device="cpu")
    frames = None
    if cfg.family in ("encdec", "vlm"):
        frames = torch.randn(b, cfg.n_frontend_tokens, cfg.d_model) * 0.02
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (b, 10))).int()
    nxt, caches = TF.prefill(cfg, params, toks, caches, frames)
    live = torch.tensor([True, False, True])
    before = {k: (v.data_ptr(), v.clone()) for k, v in _leaves(caches).items()}
    for _ in range(3):
        nxt, out = TF.decode_step(cfg, params, nxt, caches, live)
        assert out is caches
    after = _leaves(caches)
    assert after.keys() == before.keys()
    for key, (ptr, old) in before.items():
        assert after[key].data_ptr() == ptr, key
        if key[-1] == "lengths" and key[0] == "cross":
            assert torch.equal(after[key], old), key
        elif cfg.n_experts and key[-1] in ("k", "v", "k_scale", "v_scale"):
            continue  # the free row's entry past its length is rewritten
        else:
            assert torch.equal(after[key][:, 1], old[:, 1]), key


def test_serving_paths_keep_the_engines_parameter_tensors():
    """The captured decode step reads the parameters' storage, so no serving
    path may swap an engine's parameter tensors after construction: the
    colocated loop (an engine that live-scales in) and the disaggregated
    runtime (engines made, mutated and retired as it scales) leave every
    engine on the caller's dict, its leaves the same tensors in the same
    storage."""
    from repro_torch.launch import serve

    params = TF.init_params(CFG, 0, device="cpu")
    before = {k: (v, v.data_ptr()) for k, v in _leaves(params).items()}
    base = ["--device", "cpu", "--requests", "6", "--gen-len", "5"]
    out = serve.run_colocated(serve.build_parser().parse_args(base), CFG, params)
    rt = serve.run_disagg(serve.build_parser().parse_args(base + ["--disagg"]), CFG, params)
    engines = list(out["engines"]) + [pe.engine for pe in rt.pool.all()]
    assert len(engines) >= 3
    for eng in engines:
        assert eng.params is params
    for key, (t, ptr) in before.items():
        now = _leaves(params)[key]
        assert now is t and now.data_ptr() == ptr, key


def test_engine_on_the_cpu_steps_eagerly_and_never_captures(weights):
    """Only an engine on CUDA captures its decode step (at its first
    admission); on the CPU nothing is pending and no graph is made."""
    _, params = weights
    eng = InstanceEngine(CFG, params, n_slots=2, max_seq=32)
    assert not eng._capture_pending and eng._graph is None
    eng.submit(ServeRequest(0, _prompts(1)[0], 3))
    assert len(eng.run_until_done()) == 1
    assert eng._graph is None and eng._graph_launches == {}


def test_uncounted_launches_and_replayed_counts():
    """ops.uncounted() leaves the counters as they were and reports the
    launches made inside it; add_launch_counts() adds a replay's."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    ops.add_launch_counts({"rmsnorm": 2})
    with ops.uncounted() as inside:
        ops.add_launch_counts({"rmsnorm": 5, "decode_attention": 3})
    assert inside == {"rmsnorm": 5, "flash_attention": 0, "decode_attention": 3,
                      "rmsnorm_bwd": 0, "flash_attention_bwd": 0}
    assert ops.launch_counts()["rmsnorm"] == 2 and ops.launch_counts()["decode_attention"] == 0
    ops.add_launch_counts(inside)
    assert ops.launch_counts()["rmsnorm"] == 7
    ops.reset_launch_counts()
