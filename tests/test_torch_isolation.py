"""The port stands alone: no JAX, nothing of ld_tools_tpu, cuda by default."""

import ast
import os
import pkgutil
import subprocess
import sys
import types

import pytest
import torch

import ld_tools_tpu_torch

PORT_DIR = os.path.dirname(ld_tools_tpu_torch.__file__)
REPO = os.path.dirname(PORT_DIR)


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages([PORT_DIR], prefix="ld_tools_tpu_torch.")
    )


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {_port_modules()!r}\n"
        "import ld_tools_tpu_torch\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'ld_tools_tpu' or k.startswith('ld_tools_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_the_walk_covers_the_measurement_path():
    """The import check above walks the bench and parallel modules too
    (the bench's ``__main__`` runs nothing on import)."""
    mods = set(_port_modules())
    assert {
        "ld_tools_tpu_torch.bench.__main__", "ld_tools_tpu_torch.bench.common",
        "ld_tools_tpu_torch.bench.headline", "ld_tools_tpu_torch.bench.kernels",
        "ld_tools_tpu_torch.bench.microkernels",
        "ld_tools_tpu_torch.bench.oracle", "ld_tools_tpu_torch.bench.suite",
        "ld_tools_tpu_torch.parallel.batch", "ld_tools_tpu_torch.utils.profiling",
    } <= mods


def test_sources_import_no_jax_and_nothing_of_the_jax_package():
    for root, dirs, files in os.walk(PORT_DIR):
        if "_build" in dirs:  # build outputs, not sources of the port
            dirs.remove("_build")
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or ""]
                else:
                    continue
                for mod in mods:
                    top = mod.split(".")[0]
                    assert top not in ("jax", "jaxlib", "ld_tools_tpu"), (
                        path, mod)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    from ld_tools_tpu_torch.utils.device import resolve_device

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_scan_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    import numpy as np

    from ld_tools_tpu_torch.ops.ld_stream import stream_threshold_scan

    _no_card(monkeypatch)
    G = (np.random.default_rng(0).random((8, 16)) < 0.5).astype(np.int8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        stream_threshold_scan(G, thres=0.5)
    assert stream_threshold_scan(G, thres=0.5, device="cpu").exact


def test_cli_defaults_to_cuda_and_raises_without_a_card(monkeypatch, tmp_path):
    from ld_tools_tpu_torch import ld_scan

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ld_scan.main(["-C", "21", "-D", str(tmp_path), "-t", str(tmp_path)])
    # nothing was prepared: the device check runs before the data prep
    assert not os.path.exists(tmp_path / "conversion.db")


@pytest.mark.parametrize("flag,value", [("-d", "2"), ("-k", "ckpt")])
def test_cli_unported_flags_raise(flag, value, tmp_path):
    from ld_tools_tpu_torch import ld_scan

    with pytest.raises(NotImplementedError):
        ld_scan.main(["-C", "21", "-D", str(tmp_path), "-t", str(tmp_path),
                      "-E", "torch", flag, value])


@pytest.mark.parametrize("kw", [
    {"checkpoint_dir": "x"}, {"mesh": object()}, {"multiprocess": True},
])
def test_scan_unported_options_raise(kw):
    import numpy as np

    from ld_tools_tpu_torch.ops.ld_stream import stream_threshold_scan

    G = np.zeros((4, 16), dtype=np.int8)
    with pytest.raises(NotImplementedError):
        stream_threshold_scan(G, thres=0.5, device="cpu", **kw)


def test_packed_resident_raises_without_a_card(monkeypatch):
    """resident="packed" runs the packed kernels on the card: with no
    card it raises, and nothing falls back to the CPU."""
    import numpy as np

    from ld_tools_tpu_torch.ops.ld_stream import stream_threshold_scan

    _no_card(monkeypatch)
    gp = np.zeros((4, 2), dtype=np.uint8)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            stream_threshold_scan(G_packed=gp, n_haplotypes=16, thres=0.5,
                                  resident="packed", **kw)


@pytest.mark.parametrize("resident", ["bitplane", "PACKED", ""])
def test_scan_unknown_resident_raises(resident):
    import numpy as np

    from ld_tools_tpu_torch.ops.ld_stream import stream_threshold_scan

    G = np.zeros((4, 16), dtype=np.int8)
    with pytest.raises(ValueError, match="resident"):
        stream_threshold_scan(G, thres=0.5, device="cpu", resident=resident)


def test_mixed_ploidy_scan_raises():
    from ld_tools_tpu_torch.tools.scan import _scan_mixed_chromosome

    with pytest.raises(NotImplementedError, match="queue 5"):
        _scan_mixed_chromosome(None, types.SimpleNamespace(chrom="X"), None,
                               None)


def test_wrappers_refuse_other_devices():
    from ld_tools_tpu_torch.ops import ld_kernels

    g = torch.zeros((4, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ld_kernels.ld_triangle_matrix(g, block_m=128, block_n=128)


def test_builds_go_to_the_port_build_directory():
    from ld_tools_tpu_torch.ingest import _vcfpack_ctypes
    from ld_tools_tpu_torch.ops import _cuda_build, _exactfinish_ctypes
    from ld_tools_tpu_torch.utils.paths import BUILD_DIR

    assert BUILD_DIR == os.path.join(PORT_DIR, "_build")
    for lib in (_vcfpack_ctypes._LIB, _exactfinish_ctypes._LIB,
                _cuda_build.LIB):
        assert os.path.dirname(lib) == BUILD_DIR
    assert "-fmad=false" in _cuda_build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _cuda_build.NVCC_FLAGS
