"""The port's checkpoints: the reference's on-disk format both ways (a JAX
checkpoint restored by the port and a port checkpoint restored by JAX, bit
for bit, bf16 leaves and AdamW's int32 step included), atomic publish and
pruning, and a killed-and-resumed training run that reproduces the
unbroken run's trajectory.  CPU, REDUCED granite-8b."""

import json
import os

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as JOPT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import run_train  # noqa: E402
from repro_torch.models import bridge  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import optimizer as OPT  # noqa: E402


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)) if isinstance(v, dict) else {path + (k,): v})
    return out


def _bits(x):
    """A leaf's bytes as a numpy array of its stored width (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def _assert_same_bits(got, want):
    fg, fw = _flat(got), _flat(want)
    assert fg.keys() == fw.keys()
    for k in fw:
        a, b = _bits(fg[k]), _bits(fw[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=str(k))


def _jax_state(dtype):
    """JAX params (in ``dtype``) and AdamW state with f32 moments, after one
    update so that the moments and step are not zero."""
    jcfg = jax_get_config("granite-8b", reduced=True).replace(dtype=dtype)
    params = JTF.init_params(jax.random.PRNGKey(3), jcfg)
    opt_cfg = JOPT.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, opt, _ = JOPT.adamw_update(params, grads, JOPT.adamw_init(params, opt_cfg), opt_cfg)
    return {"params": params, "opt": opt}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_jax_checkpoint_restores_into_the_port_bit_for_bit(tmp_path, dtype):
    jstate = _jax_state({"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    jckpt.save_checkpoint(str(tmp_path), 7, jstate)
    np_state = jax.tree.map(np.asarray, jstate)
    target = {"params": bridge.params_from_numpy(np_state["params"], device="cpu"),
              "opt": bridge.opt_state_from_numpy(np_state["opt"], device="cpu")}
    for leaf in OPT.tree_leaves(target):  # a target of the right shapes, other values
        leaf.zero_()
    state, step = ckpt.restore_checkpoint(str(tmp_path), target)
    assert step == 7 and ckpt.latest_step(str(tmp_path)) == 7
    assert state["opt"]["step"].dtype == torch.int32 and state["opt"]["step"].dim() == 0
    _assert_same_bits(state, np_state)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_port_checkpoint_restores_into_jax_bit_for_bit(tmp_path, dtype):
    cfg = get_config("granite-8b", reduced=True).replace(
        dtype={"f32": torch.float32, "bf16": torch.bfloat16}[dtype])
    params = TF.init_params(cfg, 4, device="cpu")
    opt_cfg = OPT.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)

    def full(tree):
        return {k: full(v) for k, v in tree.items()} if isinstance(tree, dict) else torch.full_like(tree, 0.01)

    grads = full(params)
    params, opt, _ = OPT.adamw_update(params, grads, OPT.adamw_init(params, opt_cfg), opt_cfg)
    state = {"params": params, "opt": opt}
    path = ckpt.save_checkpoint(str(tmp_path), 3, state)
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    assert path.endswith("step_00000003") and manifest["step"] == 3
    assert manifest["leaves"]["opt/step"] == {"file": "opt__step.npy", "shape": [], "dtype": "int32"}
    want_dtype = "bfloat16" if dtype == "bf16" else "float32"
    assert manifest["leaves"]["params/embed/tok"]["dtype"] == want_dtype
    target = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), _jax_state(
        {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]))
    jstate, step = jckpt.restore_checkpoint(str(tmp_path), target)
    assert step == 3
    _assert_same_bits(jax.tree.map(np.asarray, jstate), state)


def test_restore_refuses_a_mismatched_target(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, {"x": torch.arange(5.0)})
    with pytest.raises(ValueError, match="checkpoint leaf x"):
        ckpt.restore_checkpoint(str(tmp_path), {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="checkpoint leaf x"):
        ckpt.restore_checkpoint(str(tmp_path), {"x": torch.zeros(5, dtype=torch.bfloat16)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), {"x": torch.zeros(5)})


def test_checkpoint_atomicity_and_pruning(tmp_path):
    d = str(tmp_path)
    tree = {"x": torch.arange(5.0)}
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(d, s, tree, keep=2)
    assert ckpt.latest_step(d) == 4
    assert ckpt.all_steps(d) == [3, 4]
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]  # pruned
    os.makedirs(os.path.join(d, "step_00000009.tmp"))  # a write cut short
    os.makedirs(os.path.join(d, "step_00000010"))  # a directory with no manifest
    assert ckpt.latest_step(d) == 4
    restored, step = ckpt.restore_checkpoint(d, {"x": torch.zeros(5)})
    assert step == 4 and torch.equal(restored["x"], tree["x"])
    assert ckpt.latest_step(str(tmp_path / "missing")) is None


def test_killed_and_resumed_run_reproduces_the_trajectory(tmp_path, capsys):
    """Train 8 steps with a checkpoint every 4; separately train to step 4
    ("killed" there) and restart with the same directory: the restart
    resumes from step 4 and gives the unbroken run's losses for steps 4-7
    and its final weights and optimizer state, bit for bit."""
    cfg = get_config("granite-8b", reduced=True).replace(dtype=torch.float32)
    opt_cfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    kw = dict(batch=4, seq=16, microbatches=2, ckpt_every=4, log_every=100, seed=5, device="cpu")
    whole = run_train(cfg, opt_cfg, steps=8, ckpt_dir=str(tmp_path / "a"), **kw)
    run_train(cfg, opt_cfg, steps=4, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = run_train(cfg, opt_cfg, steps=8, ckpt_dir=str(tmp_path / "b"), **kw)
    assert "resumed from step 4" in capsys.readouterr().out
    assert whole["start_step"] == 0 and resumed["start_step"] == 4
    assert resumed["losses"] == whole["losses"][4:]
    _assert_same_bits({"p": resumed["params"], "o": resumed["opt_state"]},
                      {"p": whole["params"], "o": whole["opt_state"]})
    assert ckpt.all_steps(str(tmp_path / "a")) == [4, 8]
