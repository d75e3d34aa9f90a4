"""The PyTorch port stays framework-neutral: its copied files equal the JAX
package's originals up to the package rename, and no module of the port
(nor chip_smoke.py or scripts/profile_port.py) imports JAX, the JAX
package or the JAX system's driver entry (``__graft_entry__``)."""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "aefs_tpu_torch"
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "aefs_tpu", "__graft_entry__"}


@pytest.mark.parametrize(
    "rel", ["core/config.py", "core/multiband.py", "engine/wavio.py", "native.py",
            "utils/tempo.py", "engine/devices.py"])
def test_copied_file_matches_original(rel):
    """Equal once imports of ``aefs_tpu.`` / ``from aefs_tpu import`` name
    the port instead."""
    orig = (ROOT / "aefs_tpu" / rel).read_text()
    port = (PORT / rel).read_text()
    renamed = re.sub(r"\baefs_tpu(?=\.)", "aefs_tpu_torch", orig)
    renamed = re.sub(r"\bfrom aefs_tpu import\b", "from aefs_tpu_torch import", renamed)
    assert renamed == port


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py", "scripts/profile_port.py",
                                         "scripts/shard_dispatch.py"])
def test_no_jax_import(rel):
    bad = sorted(set(_imported_roots(ROOT / rel)) & FORBIDDEN)
    assert not bad, (rel, bad)


@pytest.mark.parametrize("rel", [
    "aefs_tpu_torch/engine/checkpoint.py", "aefs_tpu_torch/engine/devices.py",
    "aefs_tpu_torch/utils/analysis.py", "aefs_tpu_torch/utils/metrics.py",
    "aefs_tpu_torch/utils/platform.py", "aefs_tpu_torch/utils/tempo.py",
    "aefs_tpu_torch/server/__init__.py", "aefs_tpu_torch/server/pool.py",
    "aefs_tpu_torch/server/backend.py", "aefs_tpu_torch/ui/__init__.py",
    "aefs_tpu_torch/ui/app.py", "aefs_tpu_torch/run.py",
    "aefs_tpu_torch/parallel/__init__.py", "aefs_tpu_torch/parallel/mesh.py"])
def test_scan_covers_session_layer_modules(rel):
    """The import scan above walks every module of the port, these too."""
    assert rel in PORT_FILES


def test_ui_assets_served_by_path_not_copied():
    """The port's UI server serves the repository's aefs_tpu/ui/assets/ by
    path; no asset file (by name or by content) lives under the port."""
    from aefs_tpu_torch.ui.app import ASSETS_DIR

    assets = ROOT / "aefs_tpu" / "ui" / "assets"
    assert pathlib.Path(ASSETS_DIR).resolve() == assets.resolve()
    originals = {f.name: f.read_bytes() for f in assets.iterdir()}
    assert originals
    for f in PORT.rglob("*"):
        if f.is_file():
            assert f.name not in originals, f
            assert f.read_bytes() not in originals.values(), f


def test_flagship_copy_matches_driver_entry():
    """The port's flagship config is the JAX driver entry's, value for value."""
    import __graft_entry__
    from aefs_tpu_torch.engine.flagship import FLAGSHIP

    assert FLAGSHIP == __graft_entry__.FLAGSHIP


def test_native_helper_resolves_to_repo_sources():
    """The copied host-side helper still builds from native/aefs_native.cpp."""
    from aefs_tpu_torch import native

    assert pathlib.Path(native._SRC) == ROOT / "native" / "aefs_native.cpp"


def test_kernel_build_dir_is_gitignored():
    from aefs_tpu_torch.ops.kernels import BUILD_DIR

    assert BUILD_DIR == ROOT / "build" / "aefs_tpu_torch"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored and "*.so" in ignored
