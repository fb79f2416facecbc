"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU at REDUCED size: the reference CLI's printed lines, a falling loss,
resuming from ``--ckpt-dir``, and the sharded meshes (A14): ``host`` on a
one-rank gloo group, ``production`` refused off a 256-rank world."""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train as train_cli  # noqa: E402

STEP_LINE = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) grad_norm (\d+\.\d{3}) tok/s [\d,]+$")


def _run(capsys, *argv):
    train_cli.main(["--device", "cpu", "--reduced", *argv])
    out = capsys.readouterr().out.splitlines()
    steps = {int(m[1]): float(m[2]) for m in map(STEP_LINE.match, out) if m}
    return out, steps


def test_cli_trains_and_the_loss_falls(capsys):
    out, steps = _run(capsys, "--steps", "16", "--batch", "8", "--seq", "64", "--lr", "3e-3",
                      "--log-every", "5")
    assert out[0].startswith("arch=granite-8b-reduced params=") and out[-1] == "done"
    assert sorted(steps) == [0, 5, 10, 15]
    assert steps[15] < steps[0] - 0.1


def test_cli_resumes_from_its_checkpoint(capsys, tmp_path):
    argv = ("--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
            "--log-every", "1", "--microbatches", "2")
    out, first = _run(capsys, "--steps", "6", *argv)
    assert not any(line.startswith("resumed") for line in out)
    assert sorted(first) == list(range(6))
    out, second = _run(capsys, "--steps", "8", *argv)
    assert "resumed from step 6" in out
    assert sorted(second) == [6, 7]


@pytest.mark.parametrize("mesh", ["host", "production"])
def test_cli_sharded_meshes_wait_for_a14(mesh, capsys, tmp_path):
    """(The name is the refusal's this test once checked; A14 is now
    ported.)  ``--mesh host`` trains sharded on a one-rank group, from the
    unsharded run's weights and batches, and resumes from its checkpoint;
    ``--mesh production`` off a world of 256 ranks raises the ValueError
    that names them, and leaves no process group behind."""
    if mesh == "production":
        with pytest.raises(ValueError, match="256 ranks"):
            train_cli.main(["--device", "cpu", "--reduced", "--mesh", mesh])
        assert not torch.distributed.is_initialized()
        return
    argv = ("--batch", "4", "--seq", "16", "--log-every", "1", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3")
    _, plain = _run(capsys, "--steps", "3", "--batch", "4", "--seq", "16", "--log-every", "1")
    out, sharded = _run(capsys, "--mesh", "host", "--steps", "3", *argv)
    assert out[-1] == "done" and sorted(sharded) == [0, 1, 2]
    assert sharded == plain  # one rank: the same weights, batches and arithmetic
    assert not torch.distributed.is_initialized()
    out, resumed = _run(capsys, "--mesh", "host", "--steps", "5", *argv)
    assert "resumed from step 3" in out and sorted(resumed) == [3, 4]
