"""The port imports torch and nothing of jax or of the JAX package: every
module of lut_renderer_tpu_torch, and every module chip_smoke.py imports,
imported in a fresh interpreter, leaves both out of sys.modules; an AST
scan of the sources finds no import of either; a job with a CRF set builds
its render spec through the port alone."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "lut_renderer_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "lut_renderer_tpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _imported(path: Path):
    """Absolute module names `path` imports, at any depth of its code."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


_CHECK = (
    "bad = sorted(m for m in sys.modules if m in {f!r} or "
    "m.startswith(tuple(x + '.' for x in {f!r})))\n"
    "assert not bad, bad\n"
    "print('ok', len(sys.modules))\n").format(f=FORBIDDEN)


def _fresh(code: str) -> None:
    res = subprocess.run([sys.executable, "-c", code + _CHECK], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")


def test_port_modules_import_no_jax():
    mods = list(_modules())
    assert "lut_renderer_tpu_torch.ops.fused420" in mods
    assert "lut_renderer_tpu_torch.app.cli" in mods
    smoke = sorted({m for m in _imported(REPO / "chip_smoke.py")
                    if m.startswith("lut_renderer_tpu_torch")})
    assert "lut_renderer_tpu_torch.hostio.decode" in smoke
    _fresh("import importlib, sys\n"
           f"for m in {mods + smoke + ['chip_smoke']!r}:\n"
           "    importlib.import_module(m)\n")


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_nothing_of_jax_or_the_jax_package(path):
    bad = sorted(m for m in _imported(path) if _forbidden(m))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_crf_job_builds_its_spec_without_jax():
    """plan/policy.py reaches engine.config.crf_mechanism for a CRF: the
    port's own copy of both."""
    _fresh(
        "import sys\n"
        "from pathlib import Path\n"
        "from lut_renderer_tpu_torch.models import ProcessingParams\n"
        "from lut_renderer_tpu_torch.plan import build_render_spec\n"
        "for codec in ('libvpx-vp9', 'mpeg4'):\n"
        "    spec = build_render_spec(Path('/in/a.mp4'), Path('/o/a.mkv'),\n"
        "        ProcessingParams(video_codec=codec, crf='28'),\n"
        "        Path('/l/a.cube'), None)\n"
        "    assert spec.crf == '28', spec\n")


def test_kernel_sources_ship_with_the_package():
    names = {p.name for p in (PKG / "csrc").iterdir()}
    assert {"lut3d.cu", "coarse2.cu", "fused420.cu",
            "lut_interp.cuh"} <= names
    from lut_renderer_tpu_torch.ops import _build

    assert set(_build.SOURCES) | set(_build.HEADERS) <= names
