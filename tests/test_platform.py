"""Platform rules: no TPU-only code, the compile-cache location, and the
entry points that must refuse to run without a GPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _python_sources():
    files = sorted((ROOT / "tcgnn").rglob("*.py"))
    return files + [ROOT / "bench.py", ROOT / "__graft_entry__.py",
                    ROOT / "chip_smoke.py"]


def test_no_module_imports_pallas_tpu():
    bad = []
    for path in _python_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [
                    f"{node.module}.{a.name}" for a in node.names
                ]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            if any(n.startswith("jax.experimental.pallas.tpu") for n in names):
                bad.append(str(path.relative_to(ROOT)))
    assert not bad, bad


def test_no_interpret_default_in_library():
    """Only tests ask for interpret mode: no library call passes
    ``interpret=True`` or derives it from the backend."""
    for path in _python_sources():
        src = path.read_text()
        assert "interpret=True" not in src, path
        assert "default_interpret" not in src, path


def test_compile_cache_rule():
    import tcgnn

    assert tcgnn.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) == "/x/y"
    assert tcgnn.compile_cache_dir({}) == str(ROOT / ".cache" / "jax")
    assert tcgnn.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == str(
        ROOT / ".cache" / "jax"
    )


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_applied_on_import(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = str(ROOT / ".cache" / "jax")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import tcgnn, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[-1]
    assert out == want


def test_native_library_keyed_and_outside_package():
    from tcgnn.sgt import native

    path = pathlib.Path(native.library_path())
    assert path.parent == ROOT / ".cache" / "native"
    assert path.name.startswith("libsgt-") and path.suffix == ".so"
    assert not list((ROOT / "tcgnn" / "sgt" / "native").glob("*.so"))


def test_chip_smoke_device_phase_refuses_cpu():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase_device()


def test_bench_refuses_cpu():
    sys.path.insert(0, str(ROOT))
    import bench

    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.main()
