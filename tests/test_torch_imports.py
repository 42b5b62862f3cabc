"""Import hygiene of the PyTorch port: ``repro_torch``, ``chip_smoke.py``
and the port's examples (``examples/*_torch.py``) never import ``jax`` or
anything of ``repro`` (checked by importing every module of the package in
a fresh interpreter and by scanning every source), and the entry points
refuse to fall back to the CPU silently."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")

torch.set_num_threads(1)


def _modules():
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in FORBIDDEN


def test_importing_every_module_loads_no_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"] +
                         sorted((ROOT / "examples").glob("*_torch.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str) and _forbidden(arg.value):
                    bad.append(arg.value)
    assert not bad, f"{path}: imports {bad}"


def _tiny_sim_args():
    import dataclasses
    from repro_torch.configs import FLConfig, get_config
    cfg = dataclasses.replace(get_config("cnn-paper"), image_size=8,
                              cnn_channels=(4, 8), d_model=16)
    fl = FLConfig(num_clients=4, clients_per_round=4, num_shards=2,
                  local_epochs=1, global_rounds=1)
    return cfg, fl, {}


def test_simulator_without_device_raises_when_no_gpu(monkeypatch):
    """No card and no ``device="cpu"``: the entry point raises instead of
    running on the CPU."""
    from repro_torch.fl import FLSimulator
    from repro_torch.fl.experiment import ScenarioConfig, run_scenario
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, fl, data = _tiny_sim_args()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FLSimulator(cfg, fl, data, task="classification")
    with pytest.raises(RuntimeError):
        FLSimulator(cfg, fl, data, task="classification", device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario(ScenarioConfig(num_clients=4, clients_per_round=4,
                                    num_shards=2, global_rounds=1,
                                    local_epochs=1, samples_per_client=10,
                                    image_size=8))
    sim = FLSimulator(cfg, fl, data, task="classification", device="cpu")
    assert sim.device.type == "cpu"


def test_kernel_wrappers_reject_mixed_devices():
    from repro_torch.kernels import on_cuda
    assert on_cuda(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))


@pytest.mark.parametrize("arch", ["cnn-paper", "mamba"])
def test_init_params_without_device_raises_when_no_gpu(monkeypatch, arch):
    """``init_params`` defaults to the card, as the other entry points do:
    with none it raises instead of drawing CPU weights."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl.families import get_model_family
    from repro_torch.models import init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = (get_config(arch) if arch == "cnn-paper"
           else get_model_family(arch).build(None))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, 0)
    assert all(v.device.type == "cpu"
               for v in tree_leaves(init_params(cfg, 0, device="cpu")))


def test_from_numpy_params_without_device_raises_when_no_gpu(monkeypatch):
    """``from_numpy_params`` defaults to the card, as ``init_params`` does:
    with none it raises instead of building CPU weights."""
    import numpy as np
    from repro_torch.models import from_numpy_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": np.ones((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_numpy_params(tree)
    assert from_numpy_params(tree, device="cpu")["w"].device.type == "cpu"


def test_resolve_device_cpu_leaves_cudnn_switches_alone(monkeypatch):
    """``resolve_device`` sets cuDNN's deterministic algorithms (and no
    benchmarking) only for the card, where two runs must give the same
    bits; a CPU run leaves the process's switches as the caller set them."""
    from repro_torch.kernels import resolve_device
    for det, bench in ((False, True), (True, False)):
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", det)
        monkeypatch.setattr(torch.backends.cudnn, "benchmark", bench)
        assert resolve_device("cpu").type == "cpu"
        assert torch.backends.cudnn.deterministic is det
        assert torch.backends.cudnn.benchmark is bench


SYSTEMS = ("telemetry", "faults", "durability", "service", "tiering")


@pytest.mark.parametrize("pkg", SYSTEMS)
def test_systems_packages_import_alone_with_reference_names(pkg):
    """Each systems package of the port, with every module under it,
    imports in a fresh interpreter without jax or ``repro``, and exports
    the reference package's public names (less the reference's
    ``hlo_cost_of``, which has no torch counterpart)."""
    mods = [m for m in _modules()
            if m == f"repro_torch.{pkg}"
            or m.startswith(f"repro_torch.{pkg}.")]
    assert len(mods) > 1
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    import importlib
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    names = set(getattr(ref, "__all__", None) or
                [n for n in vars(ref) if not n.startswith("_")
                 and not isinstance(vars(ref)[n], type(ref))])
    names -= {"hlo_cost_of"}
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, missing


@pytest.mark.parametrize("pkg", ["launch", "roofline"])
def test_training_and_dry_run_packages_import_alone(pkg):
    """The training slice's packages, every module under them, import in
    a fresh interpreter without jax or ``repro``; ``roofline`` keeps the
    reference's ``model_flops`` and peak names beside the card's."""
    mods = [m for m in _modules()
            if m == f"repro_torch.{pkg}"
            or m.startswith(f"repro_torch.{pkg}.")]
    assert len(mods) > 2
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    import importlib
    port = importlib.import_module(f"repro_torch.{pkg}")
    if pkg == "roofline":
        for name in ("model_flops", "PEAK_FLOPS", "HBM_BW"):
            assert hasattr(port, name), name
