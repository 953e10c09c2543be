"""The port imports torch and never jax: every module of
lut_renderer_tpu_torch, imported in a fresh interpreter, leaves jax out of
sys.modules."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "lut_renderer_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_modules_import_no_jax():
    mods = list(_modules())
    assert "lut_renderer_tpu_torch.ops.fused420" in mods
    assert "lut_renderer_tpu_torch.app.cli" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")


def test_kernel_sources_ship_with_the_package():
    names = {p.name for p in (PKG / "csrc").iterdir()}
    assert {"lut3d.cu", "fused420.cu", "lut_interp.cuh"} <= names
    from lut_renderer_tpu_torch.ops import _build

    assert set(_build.SOURCES) | set(_build.HEADERS) <= names
