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
