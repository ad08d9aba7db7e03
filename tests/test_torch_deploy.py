"""The port's deployment surface: its systemd units and installer
(``deploy/cbd-torch-*``, ``deploy/install_torch.sh``), its console scripts
(``pyproject.toml``) and its demo (``examples/demo_torch.py``).

Each unit's ``ExecStart`` (with ``%i`` = 0 and ``${ETCD_HOST}`` filled in)
parses under the port CLI's own ``argparse`` parser and names the port's
package, with the JAX unit's flags; the installer passes ``bash -n``;
every ``cbd-torch-*`` entry point imports to a callable ``main``; every
kernel source and header ships as package data; the demo runs on the CPU,
exit 0, every slow dump equal to the golden file."""

import importlib
import os
import re
import shlex
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

from caltech_bifrost_dsp_tpu_torch.ops.kernels import _build

REPO = Path(__file__).resolve().parents[1]
DEPLOY = REPO / "deploy"
ETCD = "kv://127.0.0.1:4440"


def exec_start(unit: Path) -> list:
    """The unit's ``ExecStart`` argv, continuation lines joined, the
    instance 0 and the etcd host filled in."""
    text = re.sub(r"\\\n\s*", " ", unit.read_text())
    line = next(ln for ln in text.splitlines() if ln.startswith("ExecStart="))
    line = line.replace("%i", "0").replace("${ETCD_HOST}", ETCD)
    return shlex.split(line.partition("=")[2])


def unit_keys(unit: Path) -> set:
    return {ln.partition("=")[0] for ln in unit.read_text().splitlines()
            if "=" in ln and not ln.startswith("#")}


UNITS = {"cbd-torch-pipeline@.service": "cbd-tpu-pipeline@.service",
         "cbd-torch-xeng-manager.service": "cbd-tpu-xeng-manager.service"}


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_unit_exec_start_parses_under_the_port_cli(unit):
    argv = exec_start(DEPLOY / unit)
    assert argv[:2] == ["/usr/bin/python3", "-m"]
    module = argv[2]
    assert module.startswith("caltech_bifrost_dsp_tpu_torch.scripts.")
    args = importlib.import_module(module).build_parser().parse_args(argv[3:])
    assert args.etcdhost == ETCD
    # the JAX unit's flags, against the port's module of the same name
    jax_argv = exec_start(DEPLOY / UNITS[unit])
    assert jax_argv[2] == module.replace("_torch", "")
    flags = [a for a in argv[3:] if a.startswith("--")]
    assert flags == [a for a in jax_argv[3:] if a.startswith("--")]
    if "pipeline" in module:
        assert (args.pipelineid, args.port, args.ip) == (0, 10000, "0.0.0.0")
        assert args.device == "cuda"
        assert args.logfile == "/var/log/cbd-torch/pipeline-0.log"


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_unit_reads_its_environment_file(unit):
    keys = unit_keys(DEPLOY / unit)
    assert {"EnvironmentFile", "ExecStart", "Restart"} <= keys
    assert unit_keys(DEPLOY / UNITS[unit]) - {"Description"} <= keys
    text = (DEPLOY / unit).read_text()
    if "pipeline" in unit:
        assert "CUDA_VISIBLE_DEVICES" in text
        assert "2 cards and 4 pipelines per server" in text


def test_installer_syntax_and_its_units():
    script = DEPLOY / "install_torch.sh"
    proc = subprocess.run(["bash", "-n", str(script)], capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stderr
    text = script.read_text()
    for unit in UNITS:
        assert f"deploy/{unit}" in text and (DEPLOY / unit).exists()
    assert "native.build()" in text and "_build.library()" in text
    assert "caltech_bifrost_dsp_tpu." not in text


def _scripts() -> dict:
    with open(REPO / "pyproject.toml", "rb") as fh:
        return tomllib.load(fh)["project"]["scripts"]


def test_every_jax_command_has_a_port_command():
    scripts = _scripts()
    jax = {k.replace("cbd-tpu-", "") for k in scripts
           if k.startswith("cbd-tpu-")}
    port = {k.replace("cbd-torch-", "") for k in scripts
            if k.startswith("cbd-torch-")}
    assert jax <= port, jax - port


#: port scripts whose JAX counterpart has another name and no command
RENAMED = {"gpu_parity": "tpu_parity"}


@pytest.mark.parametrize("name", sorted(k for k in _scripts()
                                        if k.startswith("cbd-torch-")))
def test_port_command_imports_its_main(name):
    target = _scripts()[name]
    module, _, attr = target.partition(":")
    assert module.startswith("caltech_bifrost_dsp_tpu_torch.scripts.")
    base = module.rsplit(".", 1)[1]
    twin = _scripts().get(name.replace("cbd-torch-", "cbd-tpu-"))
    if base in RENAMED:
        assert twin is None
        assert (REPO / "caltech_bifrost_dsp_tpu" / "scripts"
                / f"{RENAMED[base]}.py").is_file()
    else:
        assert twin.partition(":")[0].rsplit(".", 1)[1] == base
    assert callable(getattr(importlib.import_module(module), attr))


def test_parity_gate_has_a_command():
    assert (_scripts()["cbd-torch-parity"]
            == "caltech_bifrost_dsp_tpu_torch.scripts.gpu_parity:main")


def _package_data() -> list:
    with open(REPO / "pyproject.toml", "rb") as fh:
        setuptools = tomllib.load(fh)["tool"]["setuptools"]
    return setuptools["package-data"]["caltech_bifrost_dsp_tpu_torch"]


@pytest.mark.parametrize("name", [p.name for p in _build._sources()
                                  + _build._headers()])
def test_package_data_ships_every_kernel_file(name):
    """A non-editable install (a wheel, ``pip install .``) carries only
    package data: every source ``_build`` compiles and every header they
    include must match one of its globs, or the kernels cannot build."""
    pkg = REPO / "caltech_bifrost_dsp_tpu_torch"
    shipped = {p for pattern in _package_data() for p in pkg.glob(pattern)}
    assert _build.CSRC / name in shipped


def test_demo_runs_on_cpu_with_exact_products():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "demo_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "golden checks passed: 2/2" in proc.stdout
    assert "fast dumps: 4, slow dumps: 2" in proc.stdout
    assert proc.stdout.rstrip().endswith("demo OK")
