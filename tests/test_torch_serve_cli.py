"""The port's serving CLI (``repro_torch.launch.serve``) at REDUCED size on the
CPU: the colocated and ``--disagg`` modes run to the end, ``--disagg`` reports
every handoff complete and no request dropped, ``--maas`` raises, and without
``--device`` a machine without CUDA raises instead of running on the CPU."""

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


def test_maas_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP.md A15"):
        serve.main(CPU + ["--maas"])


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--disagg", "--requests", "2"])
