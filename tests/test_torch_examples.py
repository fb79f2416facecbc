"""The six examples of ``examples_torch/`` on the CPU, against the JAX
package's ``examples/``.

``quickstart``, ``net_scenarios`` and ``serve_maas`` (whose fleet runs on a
simulated clock) print what the JAX examples print, line for line, with only
the wall-clock figures masked.  ``serve_autoscale`` and ``serve_disagg`` run
on the wall clock: every request is served, every handoff completes and none
is gapped, at the JAX examples' sizes.  ``train_100m`` prints the JAX
example's parameter count, and a checkpoint of its state at step 2 is
resumed.  Without ``--device`` each example that holds tensors raises where
there is no CUDA.
"""

from __future__ import annotations

import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch.training.checkpoint import save_checkpoint

REPO = pathlib.Path(__file__).resolve().parent.parent
TENSOR_EXAMPLES = ("serve_maas", "serve_autoscale", "serve_disagg", "train_100m")


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_example(name: str):
    return _load(REPO / "examples" / f"{name}.py", f"_jax_example_{name}")


def port_example(name: str):
    return _load(REPO / "examples_torch" / f"{name}.py", f"_torch_example_{name}")


WALL_CLOCK = re.compile(r"in \d+\.\d+ ms")  # quickstart's plan and ILP times


def _masked(text: str) -> str:
    return WALL_CLOCK.sub("in X ms", text)


@pytest.mark.parametrize("name", ["quickstart", "net_scenarios"])
def test_host_examples_print_what_the_jax_examples_print(capsys, name):
    jax_example(name).main()
    want = capsys.readouterr().out
    port_example(name).main([])
    got = capsys.readouterr().out
    assert _masked(got) == _masked(want)
    if name == "net_scenarios":
        assert got.rstrip().endswith("all five scenarios behaved as modelled")


def test_serve_maas_prints_what_the_jax_example_prints(capsys):
    jax_example("serve_maas").main()
    want = capsys.readouterr().out
    port_example("serve_maas").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert ("fleet totals: 6 grants, 1 cold starts, 3 scale-to-zero events, "
            "4.86 GPU-seconds occupied") in got
    assert "multicast source: O(1) host copy" in got


def test_serve_autoscale_serves_every_request(capsys):
    ex = port_example("serve_autoscale")
    ex.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(rf"^live scaling: +all {ex.N_REQ} requests in \d+\.\d+s$", out, re.M)
    assert re.search(rf"^stop-the-world: +all {ex.N_REQ} requests in \d+\.\d+s$", out, re.M)


def test_serve_disagg_serves_every_arrival_with_complete_handoffs(capsys):
    port_example("serve_disagg").main(["--device", "cpu"])
    out = capsys.readouterr().out
    served = re.search(r"^served (\d+) requests in ", out, re.M)
    handoffs = re.search(r"handoffs (\d+) gapped (\d+)$", out, re.M)
    assert served and handoffs, out[-2000:]
    assert int(served.group(1)) == 32
    assert int(handoffs.group(1)) == 32 and int(handoffs.group(2)) == 0


def _stub_jit(fn, **_):
    """Stands in for ``jax.jit(build_train_step(...))``: the JAX example's
    parameter count needs no compiled step."""
    return lambda params, opt, batch: (params, opt, {"loss": jnp.zeros(()), "lr": jnp.zeros(())})


def test_train_100m_counts_the_jax_parameters_and_resumes(tmp_path, capsys, monkeypatch):
    small = ["--batch", "2", "--seq", "32"]
    monkeypatch.setattr(jax, "jit", _stub_jit)
    monkeypatch.setattr("sys.argv", ["train_100m.py", "--steps", "1", *small,
                                     "--ckpt", str(tmp_path / "jax")])
    jax_example("train_100m").main()
    want = capsys.readouterr().out.splitlines()[0]
    assert want.startswith("granite-100m: 99.9M params, batch 2 x seq 32")
    monkeypatch.undo()

    ex = port_example("train_100m")
    ckpt = str(tmp_path / "torch")
    state = ex.main(["--device", "cpu", "--steps", "2", *small, "--ckpt", ckpt])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == want
    assert [ln.split()[:2] for ln in lines if ln.startswith("step")] == [["step", "0"], ["step", "1"]]
    assert state["step"] == 2
    save_checkpoint(ckpt, 2, {"params": state["params"], "opt": state["opt"]})
    ex.main(["--device", "cpu", "--steps", "3", *small, "--ckpt", ckpt])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == want and lines[1] == "resumed from step 2"
    assert lines[2].split()[:2] == ["step", "2"]
    assert lines[-1].endswith("over 1 steps")


@pytest.mark.parametrize("name", TENSOR_EXAMPLES)
def test_tensor_examples_default_to_cuda_and_raise_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_example(name).main([])
