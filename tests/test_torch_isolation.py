"""The port stands alone: it imports neither JAX nor the reference package,
and its entry points refuse to run quietly on the host without a card."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduce_config
from repro_torch.convert import context_from_ok, params_from_jax
from repro_torch.core import from_fault_map, random_fault_map
from repro_torch.examples import fleet_retraining as retraining_example
from repro_torch.examples import fleet_serve as fleet_example
from repro_torch.examples import quickstart as quickstart_example
from repro_torch.examples import serve_faulty_chip as serve_example
from repro_torch.fleet import ShardedFleetServeEngine, suggest_population_size
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as M
from repro_torch.models import ssm as S

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert len(MODULES) >= 20


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_without_a_card_fails_and_prints_no_result(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        (tmp_path / script.name).write_text(script.read_text())
        script = tmp_path / script.name
    res = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}, timeout=120,
    )
    assert res.returncode != 0
    assert res.stdout == "", res.stdout
    assert "FAILED" in res.stderr, res.stderr


def test_entry_points_refuse_the_host_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduce_config(get_arch("smollm-135m"))
    fm = random_fault_map(0, 16, 16, 0.1)
    calls = [
        lambda: M.init_params(cfg, 0),
        lambda: M.init_cache(cfg, 1, 8),
        lambda: S.init_ssm_cache(reduce_config(get_arch("falcon-mamba-7b")), 1, torch.float32),
        lambda: from_fault_map(fm, "kernel"),
        lambda: context_from_ok(fm.ok_mask, "pallas"),
        lambda: params_from_jax(cfg, {}),
        lambda: serve_cli.main(["--arch", "smollm-135m", "--reduced"]),
        lambda: fleet_example.main(["--reduced", "--chips", "2"]),
        lambda: quickstart_example.main([]),
        lambda: serve_example.main([]),
        lambda: retraining_example.main(["--chips", "2"]),
        lambda: ShardedFleetServeEngine(cfg, [M.init_params(cfg, 0, device="cpu")]),
        lambda: suggest_population_size(cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for by name, the host is fine
    assert M.init_params(cfg, 0, device="cpu").embed.device.type == "cpu"
    assert M.init_cache(cfg, 1, 8, device="cpu")["k"].device.type == "cpu"
    assert from_fault_map(fm, "kernel", device="cpu").ok.dtype == torch.float32
    assert np.array_equal(context_from_ok(fm.ok_mask, "pallas", device="cpu").ok.numpy(), fm.ok_mask)
