"""The port's serving CLI (``repro_torch.launch.serve``) at REDUCED size on the
CPU: the colocated, ``--disagg`` and ``--maas`` modes run to the end,
``--disagg`` reports every handoff complete and no request dropped, ``--maas``
serves the JAX CLI's three default models (granite-8b, qwen1.5-4b and the MLA
model minicpm3-4b) with nothing dropped, ``--arch`` takes every registered
arch but whisper-large-v3 (the engine passes no frames, as the JAX
engine's does), and without ``--device`` a machine without CUDA raises
instead of running on the CPU."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402

CPU = ["--device", "cpu"]


def test_colocated_runs_to_the_end(capsys):
    args = serve.build_parser().parse_args(CPU + ["--requests", "8"])
    out = serve.run_colocated(args)
    assert len(out["finished"]) == 8
    assert sorted(r.rid for r in out["finished"]) == list(range(1, 9))
    assert all(len(r.out_tokens) == args.gen_len for r in out["finished"])
    eng0, eng1 = out["engines"]
    assert eng1.params is eng0.params
    assert eng1.loaded_layers == eng1.cfg.n_layers  # the scaled engine took every layer
    assert out["router"].slo_report().n == 8
    assert "served 8 requests" in capsys.readouterr().out


def test_colocated_main(capsys):
    serve.main(CPU + ["--requests", "8"])
    text = capsys.readouterr().out
    assert "[planner]" in text and "served 8 requests" in text


def test_disagg_main_completes_every_handoff(capsys):
    serve.main(CPU + ["--disagg", "--requests", "8"])
    text = capsys.readouterr().out
    assert "handoffs completed 8/8" in text
    assert "dropped or token-gapped requests: 0" in text


def test_run_disagg_returns_the_finished_runtime():
    args = serve.build_parser().parse_args(CPU + ["--disagg", "--requests", "6", "--gen-len", "5"])
    rt = serve.run_disagg(args)
    assert rt.n_outstanding == 0 and len(rt.completed) == 6
    assert rt.stats.migrations == 6 == rt.router.handoff_report()[0]
    assert all(len(r.out_tokens) == 5 for r in rt.completed.values())
    assert all(pe.engine.params is rt.params for pe in rt.pool.all())


def test_run_maas_serves_every_request_with_the_callers_model():
    """One ``run_maas`` with the CLI's topology, policies and arrival
    compression, given the caller's config and parameters for one model:
    every request is served with no gap, the fleet parks a model at zero and
    cold-starts one back, and each model's engines share its one parameter
    dict (the caller's, where it gave one)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF

    cfg = get_config("minicpm3-4b", reduced=True)
    params = TF.init_params(cfg, 5, device="cpu")
    args = serve.build_parser().parse_args(CPU + ["--maas", "--requests", "12"])
    fleet = serve.run_maas(args, {"minicpm3-4b": cfg}, {"minicpm3-4b": params})
    assert sorted(fleet.tenants) == [
        "granite-8b-reduced", "minicpm3-4b-reduced", "qwen1.5-4b-reduced"]
    mla = fleet.tenants["minicpm3-4b-reduced"].runtime
    assert mla.cfg is cfg and mla.params is params and cfg.attn == "mla"
    assert fleet.n_outstanding == 0
    assert fleet.stats.scale_to_zero_events >= 1 and fleet.stats.cold_starts >= 1
    assert fleet.param_pool.invariant_ok()
    for t in fleet.tenants.values():
        rt = t.runtime
        assert rt.router.handoff_report()[1] == 0
        assert all(len(r.out_tokens) == args.gen_len for r in rt.completed.values())
        assert all(pe.engine.params is rt.params for pe in rt.pool.all())
    assert sum(len(t.runtime.completed) for t in fleet.tenants.values()) == 12


def test_maas_main_serves_every_request(capsys):
    serve.main(CPU + ["--maas", "--requests", "12"])
    text = capsys.readouterr().out
    assert "[maas] fleet:" in text
    assert ": at zero (host copy only)" in text and ": cold start (" in text
    served = [int(line.split(": ")[1].split()[0]) for line in text.splitlines()
              if line.startswith("[maas] ") and "served" in line]
    assert len(served) == 3 and sum(served) == 12
    with pytest.raises(SystemExit, match="at least two"):
        serve.main(CPU + ["--maas", "--models", "granite-8b"])


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--disagg", "--requests", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--maas", "--requests", "2"])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b"])
def test_moe_ssm_and_hybrid_archs_serve(arch, capsys):
    """``--arch`` with the MoE, SSM and hybrid archs: the colocated loop and
    ``--disagg`` (the SSM state, and the hybrid's shared-block caches,
    migrate prefill -> decode) run to the end with nothing dropped."""
    serve.main(CPU + ["--arch", arch, "--requests", "4"])
    serve.main(CPU + ["--arch", arch, "--disagg", "--requests", "6"])
    text = capsys.readouterr().out
    assert "served 4 requests" in text
    assert "handoffs completed 6/6" in text
    assert "dropped or token-gapped requests: 0" in text


@pytest.mark.parametrize("arch", ["grok-1-314b", "nemotron-4-340b", "pixtral-12b"])
def test_last_reference_archs_serve_colocated(arch, capsys):
    """``--arch`` with grok-1's MoE, nemotron's squared-ReLU MLP at n_rep 3
    and pixtral's VLM (text only: the engine passes no frames): the
    colocated loop runs to the end."""
    serve.main(CPU + ["--arch", arch, "--requests", "4"])
    assert "served 4 requests" in capsys.readouterr().out


def test_whisper_needs_frames_the_engine_does_not_pass():
    """whisper-large-v3 is served at the model API with frames; through the
    engine, which passes none (as the JAX engine), its encoder raises."""
    with pytest.raises(ValueError, match="needs frames"):
        serve.main(CPU + ["--arch", "whisper-large-v3", "--requests", "2"])
