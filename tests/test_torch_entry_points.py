"""The port's launch paths: every ros-vision-torch* console script of
pyproject.toml resolves to a callable in ros_vision_tpu_torch and its
--help exits 0, and the port's start script and systemd unit launch the
port's package (the counterparts of scripts/start_vision.sh and
deploy/ros_vision_tpu.service)."""
import importlib
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
DEPLOY = ROOT / "ros_vision_tpu_torch" / "deploy"
TOOLS = ("bench", "soak", "convert", "detect", "replay", "calibrate",
         "rotations", "timing-report", "extract")


def _scripts() -> dict:
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def test_every_port_tool_has_a_console_script():
    scripts = _scripts()
    port = {k for k in scripts if k.startswith("ros-vision-torch")}
    assert port == {"ros-vision-torch"} | {f"ros-vision-torch-{t}"
                                           for t in TOOLS}
    assert scripts["ros-vision-torch"] == "ros_vision_tpu_torch.launch:main"
    # the JAX package's entries stay as they were
    assert scripts["ros-vision-tpu"] == "ros_vision_tpu.launch:main"


@pytest.mark.parametrize("name", ["ros-vision-torch"]
                         + [f"ros-vision-torch-{t}" for t in TOOLS])
def test_console_script_help(name, monkeypatch, capsys):
    module, func = _scripts()[name].split(":")
    assert module.startswith("ros_vision_tpu_torch.")
    main = getattr(importlib.import_module(module), func)
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    with pytest.raises(SystemExit) as e:
        main()
    assert e.value.code in (0, None)
    assert "usage:" in capsys.readouterr().out


def test_start_script_launches_the_port():
    script = DEPLOY / "start_vision.sh"
    assert os.access(script, os.X_OK)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([str(script), "--help"], capture_output=True,
                       text=True, timeout=120, env=env, cwd="/")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "PyTorch/CUDA port" in r.stdout


def test_service_unit_runs_the_start_script():
    unit = (DEPLOY / "ros_vision_tpu_torch.service").read_text()
    lines = dict(line.split("=", 1) for line in unit.splitlines()
                 if "=" in line and not line.startswith("#"))
    assert lines["ExecStart"].endswith(
        "ros_vision_tpu_torch/deploy/start_vision.sh")
    assert lines["Restart"] == "always"
    jax_unit = (ROOT / "deploy" / "ros_vision_tpu.service").read_text()
    assert "ros_vision_tpu_torch" not in jax_unit


def test_package_data_lists_the_deploy_files():
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert {"deploy/*.sh", "deploy/*.service"} <= \
        set(data["ros_vision_tpu_torch"])
