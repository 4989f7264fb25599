"""The port's oracle soak (ros_vision_tpu_torch/tools/soak.py) against
scripts/soak.py on the JAX CPU path: a few seeds of each profile, run by
both on the CPU, score the same seeds to the same counts (failures,
knife-edge events, non-detections, gate losses) and the same exit code."""
import re
import sys

import pytest
import torch

from ros_vision_tpu_torch.tools import soak as tsoak
from scripts import soak as jsoak
from tests.torch_port_helpers import t  # noqa: F401  (sets torch threads)

CPU = torch.device("cpu")


def _jax_soak(monkeypatch, capsys, *args) -> tuple:
    """scripts/soak.py's exit code and stdout for `args`, in process."""
    monkeypatch.setattr(sys, "argv", ["soak.py", *args])
    rc = jsoak.main()
    return rc, capsys.readouterr().out


def test_parity_profile_matches_jax(monkeypatch, capsys):
    rc, out = _jax_soak(monkeypatch, capsys, "-n", "6", "-s", "40")
    m = re.search(r"(\d+) seeds, (\d+) failures, (\d+) junk-margin extras, "
                  r"(\d+) peak-tie divergences", out)
    res = tsoak.run_parity(range(40, 46), CPU)
    assert (res["seeds"], len(res["failures"]), res["junk_extras"],
            res["tie_divergences"]) == tuple(int(g) for g in m.groups())
    assert res["ok"] == (rc == 0)
    assert res["ok"]


def test_hard_profile_matches_jax(monkeypatch, capsys):
    args = ["--profile", "hard", "-n", "10", "-s", "0", "--audit-misses"]
    rc, out = _jax_soak(monkeypatch, capsys, *args)
    m = re.search(r"hard profile: (\d+) seeds, (\d+) failures, "
                  r"(\d+) non-detections", out)
    res = tsoak.run_hard(range(0, 10), CPU, audit_misses=True)
    assert (res["seeds"], len(res["failures"]), res["missed"]) == \
        tuple(int(g) for g in m.groups())
    assert res["ok"] == (rc == 0)
    assert res["scored"] >= 5
    assert res["oracle_missed"] == res["missed"]


def test_gate_profile_matches_jax(monkeypatch, capsys):
    rc, out = _jax_soak(monkeypatch, capsys, "--profile", "gate", "-n", "2")
    m = re.search(r"\((\d+) decode pairs\)", out)
    losses = re.search(r"gate losses by perturbation magnitude: (\{.*\})",
                       out).group(1)
    res = tsoak.run_gate(range(0, 2), CPU)
    assert res["cases"] == int(m.group(1)) > 0
    assert str(res["losses"]) == losses
    assert res["ok"] == (rc == 0)


@pytest.mark.parametrize("profile", ["parity", "hard", "gate"])
def test_cli_exit_codes(monkeypatch, profile):
    assert tsoak.main(["--device", "cpu", "--profile", profile,
                       "-n", "1", "-s", "3"]) == 0

    def failing(*a, **k):
        return {"ok": False}

    monkeypatch.setattr(tsoak, f"run_{profile}", failing)
    assert tsoak.main(["--device", "cpu", "--profile", profile,
                       "-n", "1"]) == 1


def test_det_kw_env(monkeypatch):
    monkeypatch.setenv("SOAK_DET_KW", '{"use_pallas_sort": true}')
    assert tsoak._det_kw_env() == {"use_pallas_sort": True}
    res = tsoak.run_parity(range(7, 9), CPU)
    assert res["ok"] and res["seeds"] == 2


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsoak.main(["-n", "1"])
