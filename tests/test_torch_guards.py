"""Port guards: the port imports neither JAX nor the reference package, and
its entry points default to the card and never fall back to the CPU."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_reference(path):
    roots = {m.split(".")[0] for m in _imported_modules(path)}
    assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, \
        f"{path} imports {sorted(roots & {'jax', 'jaxlib', 'repro'})}"


def test_port_file_list_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/serving/engine.py" in names
    assert "chip_smoke.py" in names


def _default_device_entry_points(tmp_path):
    from repro_torch.configs import get_config, tiny_config
    from repro_torch.core.manager import InstanceManager, ManagerConfig
    from repro_torch.core.pool import PagePool
    from repro_torch.weights import init_params, params_from_jax
    cfg = tiny_config(get_config("llama3.2-3b"))
    return {
        "PagePool": lambda: PagePool(64, capacity_pages=1024),
        "InstanceManager": lambda: InstanceManager(
            ManagerConfig(spool_dir=str(tmp_path)), lambda a: None),
        "init_params": lambda: init_params(cfg, torch.Generator()),
        "params_from_jax": lambda: params_from_jax(
            {"embed": np.zeros((4, 4), np.float32)}),
    }


@pytest.mark.parametrize("name", ["PagePool", "InstanceManager",
                                  "init_params", "params_from_jax"])
def test_default_device_is_the_card_with_no_cpu_fallback(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _default_device_entry_points(tmp_path)[name]()
