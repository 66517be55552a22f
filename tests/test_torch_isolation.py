"""The port stands alone: it imports neither JAX nor the reference package,
its entry points refuse to fall back to the CPU silently, and importing its
kernel modules builds nothing and imports no ``triton``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path} imports {bad}"


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=120)


def test_import_leaves_jax_and_triton_out_and_builds_nothing():
    r = _run("import sys\n"
             "import repro_torch.serving, repro_torch.launch.serve\n"
             "import repro_torch.kernels.ops, repro_torch.kernels.build as b\n"
             "bad = {'jax', 'repro', 'triton'} & set(sys.modules)\n"
             "assert not bad, bad\n"
             "assert not b._libs and not b.BUILD_LOG\n"
             "print('ok')")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_entry_points_refuse_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Transformer
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(get_config("qwen2-0.5b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])


def test_chip_smoke_fails_without_a_card():
    """No card: chip_smoke exits non-zero and prints no result line."""
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
