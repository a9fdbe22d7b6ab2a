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


def test_the_walk_covers_the_multi_device_path():
    """... and the sharded, cooperative path's modules."""
    assert {
        "ld_tools_tpu_torch.ops.ld_math", "ld_tools_tpu_torch.parallel.sweep",
        "ld_tools_tpu_torch.utils.distributed",
    } <= set(_port_modules())


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


@pytest.fixture(scope="module")
def small_store(tmp_path_factory):
    from ld_tools_tpu_torch.ingest import prep as torch_prep
    from ld_tools_tpu_torch.ingest import synth

    d = str(tmp_path_factory.mktemp("intgen"))
    synth.generate_dataset(d, n_samples=20, chrom_variant_counts={"21": 60},
                           seed=3)
    torch_prep.prep_intgen_data(d)
    return d


@pytest.mark.parametrize("flag,value", [("-d", "2"), ("-k", "ckpt")])
def test_cli_unported_flags_raise(flag, value, small_store, tmp_path,
                                  monkeypatch):
    """-d and -k once raised NotImplementedError; they now run on the CPU
    (-E torch) and write the plain scan's bytes."""
    from ld_tools_tpu_torch import ld_scan

    monkeypatch.chdir(tmp_path)
    argv = ["-C", "21", "-D", small_store, "-f", "-E", "torch", "-z", "0.5"]
    (plain,) = ld_scan.main(argv + ["-t", str(tmp_path / "plain")])
    (got,) = ld_scan.main(argv + ["-t", str(tmp_path / "opt"), flag, value])
    assert open(got.path, "rb").read() == open(plain.path, "rb").read()
    assert got.n_hits == plain.n_hits > 0
    if flag == "-d":
        assert got.stats["shards"] == 2
    else:
        assert list((tmp_path / value).glob("scan_*_batch0.npz"))


@pytest.mark.parametrize("kw", [
    {"checkpoint_dir": "x"}, {"mesh": ["cpu", "cpu"]}, {"multiprocess": True},
])
def test_scan_unported_options_raise(kw, tmp_path, monkeypatch):
    """checkpoint_dir, mesh and multiprocess once raised
    NotImplementedError; they now run on the CPU and give the plain
    scan's hits (multiprocess without a process group is the plain scan)."""
    import numpy as np

    from ld_tools_tpu_torch.ops.ld_stream import stream_threshold_scan

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    G = (rng.random((40, 16)) < 0.5).astype(np.int8)
    G[1::2] = G[::2]  # identical pairs: every run keeps hits
    plain = stream_threshold_scan(G, thres=0.5, device="cpu")
    got = stream_threshold_scan(G, thres=0.5, device="cpu", **kw)
    assert len(plain.i) > 0
    for name in ("i", "j", "r_square", "d_prime", "r_square_is_int_zero"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(plain, name))
    if "checkpoint_dir" in kw:
        assert list((tmp_path / "x").glob("scan_*_batch0.npz"))


def test_mesh_on_cuda_raises_without_a_card(monkeypatch):
    """A shard list on the card with no card raises; nothing runs on the
    CPU in its place."""
    import numpy as np

    from ld_tools_tpu_torch.ops.ld_stream import scan_mesh, stream_threshold_scan
    from ld_tools_tpu_torch.parallel import all_pairs_ring

    _no_card(monkeypatch)
    G = np.zeros((8, 16), dtype=np.int8)
    for mesh in (["cuda"], ["cuda:0", "cuda:0"]):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            stream_threshold_scan(G, thres=0.5, mesh=mesh, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        scan_mesh()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        all_pairs_ring(G)


class _FakeCudaDevice:
    """torch.cuda.device stand-in: records the device made current."""

    current = None
    entered = []

    def __init__(self, dev):
        self.dev = torch.device(dev)

    def __enter__(self):
        _FakeCudaDevice.entered.append(self.dev)
        _FakeCudaDevice.current = self.dev

    def __exit__(self, *exc):
        _FakeCudaDevice.current = None


@pytest.mark.parametrize("entry", ["ldk_band_count", "ldk_band_sweep",
                                   "ldk_triangle"])
def test_launches_make_the_tensor_device_current(entry, monkeypatch):
    """Every launch selects its tensors' card before the library call and
    passes that card's stream: with a (faked) second card, cuda:1 is
    current inside the call and the stream comes from cuda:1."""
    from ld_tools_tpu_torch.ops import _cuda_build
    from ld_tools_tpu_torch.ops import ld_kernels as lk

    seen = []

    class FakeLib:
        def __getattr__(self, name):
            def call(*args):
                seen.append((name, _FakeCudaDevice.current, args[-1]))
                return 0
            return call

    streams = {}

    def current_stream(dev):
        dev = torch.device(dev)
        return types.SimpleNamespace(cuda_stream=streams.setdefault(
            dev, 1000 + (dev.index or 0)))

    monkeypatch.setattr(_cuda_build, "lib", lambda: FakeLib())
    monkeypatch.setattr(torch.cuda, "device", _FakeCudaDevice)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    card1 = torch.device("cuda", 1)
    assert lk._launch(entry, card1, 7, 8) == 0
    assert seen == [(entry, card1, 1001)]
    # the launch sites hand the library call their tensors' device (CPU
    # tensors stand in for the card's here; the guard sees their device)
    seen.clear()
    g = torch.zeros((32, 16), dtype=torch.int8)
    vec = torch.zeros((32,), dtype=torch.float32)
    cij = torch.zeros((1,), dtype=torch.int32)
    if entry == "ldk_band_count":
        lk._count_launch(lk.ld_band_count, _cuda_build.FORM_S8, g, vec, vec,
                         vec.to(torch.int32), cij, 16, 0, 0.5, sel=0,
                         exact_mask=True, use_dist=False, block_m=16,
                         block_n=16)
    elif entry == "ldk_band_sweep":
        lk._band_sweep_launch(lk.ld_band_sweep_blocks, _cuda_build.FORM_S8,
                              g, g, vec, vec, vec, vec, cij, 16,
                              outs=("cab",), sel=0, block_m=16, block_n=16)
    else:
        lk._triangle_launch(lk.ld_triangle_blocks, _cuda_build.FORM_S8, g,
                            vec, vec, cij, 16, block_m=16, block_n=16,
                            epilogue="fast", want_dprime=False, out=None)
    assert [(name, dev) for name, dev, _ in seen] == [
        (entry, torch.device("cpu"))]
    lk.reset_launches()


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
