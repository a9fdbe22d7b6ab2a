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
        "# ld_lite renders with tabulate, which the card's machine may lack:\n"
        "# only the render step imports it\n"
        "assert 'tabulate' not in sys.modules\n"
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


def test_the_walk_covers_the_engine_and_its_tools():
    """... and the engine, ld_lite and ld_area with their CLIs and entry
    points."""
    assert {
        "ld_tools_tpu_torch.ops.engine", "ld_tools_tpu_torch.tools.lite",
        "ld_tools_tpu_torch.tools.area", "ld_tools_tpu_torch.cli._shared",
        "ld_tools_tpu_torch.cli.ld_lite_cli_en",
        "ld_tools_tpu_torch.cli.ld_lite_cli_ru",
        "ld_tools_tpu_torch.cli.ld_area_cli_en",
        "ld_tools_tpu_torch.cli.ld_area_cli_ru",
        "ld_tools_tpu_torch.ld_lite", "ld_tools_tpu_torch.ld_area",
    } <= set(_port_modules())


def test_the_walk_covers_the_triangle_and_the_entry_points():
    """... and ld_triangle with its heatmap writer and CLIs, the
    multiplexer and the entry points of ``entry``."""
    assert {
        "ld_tools_tpu_torch.io.heatmap", "ld_tools_tpu_torch.tools.triangle",
        "ld_tools_tpu_torch.cli.ld_triangle_cli_en",
        "ld_tools_tpu_torch.cli.ld_triangle_cli_ru",
        "ld_tools_tpu_torch.ld_triangle", "ld_tools_tpu_torch.__main__",
        "ld_tools_tpu_torch.entry",
    } <= set(_port_modules())


def test_the_walk_covers_the_measurement_scripts_verifier_and_gallery():
    """... and the measurement scripts, the verifier and the gallery."""
    assert {
        "ld_tools_tpu_torch.bench.scaling",
        "ld_tools_tpu_torch.bench.scaling_model",
        "ld_tools_tpu_torch.bench.smoke", "ld_tools_tpu_torch.scripts",
        "ld_tools_tpu_torch.scripts.verify_vs_reference",
        "ld_tools_tpu_torch.scripts.make_gallery",
    } <= set(_port_modules())


NEW_ENTRY_MODULES = [
    "ld_tools_tpu_torch.bench.scaling", "ld_tools_tpu_torch.bench.scaling_model",
    "ld_tools_tpu_torch.bench.smoke", "ld_tools_tpu_torch.bench.suite",
    "ld_tools_tpu_torch.scripts.verify_vs_reference",
    "ld_tools_tpu_torch.scripts.make_gallery",
]


def test_measurement_scripts_import_nothing_of_jax_or_the_scripts_package():
    """The new entry points, imported in a fresh process, pull in no JAX,
    nothing of ld_tools_tpu and nothing of the top-level ``scripts``
    package (the JAX package's scripts)."""
    code = (
        "import importlib, sys\n"
        f"for m in {NEW_ENTRY_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'ld_tools_tpu', 'scripts'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_sources_import_nothing_of_the_top_level_scripts():
    for root, dirs, files in os.walk(PORT_DIR):
        if "_build" in dirs:
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
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    mods = [node.module or ""]
                else:
                    continue
                assert all(m.split(".")[0] != "scripts" for m in mods), (
                    path, mods)


def _stand_in_reference(tmp_path):
    ref = tmp_path / "reference"
    (ref / "backend").mkdir(parents=True)
    (ref / "backend" / "calc_ld.py").write_text(
        "from tests.oracle import oracle_ld as calc_ld\n")
    return str(ref)


@pytest.mark.parametrize("entry", [
    "scaling_model", "scaling", "smoke", "suite_wg", "suite_0gb", "verify",
    "gallery",
])
def test_new_entry_points_default_to_cuda_and_raise_without_a_card(
        entry, tmp_path, monkeypatch):
    """Each measurement script, the verifier and the gallery run on the
    card unless asked for the CPU, and raise without one before any work
    (nothing is generated, prepared or written)."""
    from ld_tools_tpu_torch.bench import scaling, scaling_model, smoke, suite
    from ld_tools_tpu_torch.scripts import make_gallery, verify_vs_reference

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TPU_LD_WG_DIR", str(tmp_path / "wg"))
    monkeypatch.setenv("TPU_LD_GB_FIXTURE", str(tmp_path / "gb" / "1.vcf.gz"))
    reference = _stand_in_reference(tmp_path)
    calls = {
        "scaling_model": lambda: scaling_model.main([]),
        "scaling": lambda: scaling.main([]),
        "smoke": lambda: smoke.main(["--out", str(tmp_path / "s.json")]),
        "suite_wg": lambda: suite.main(["--configs", "wg"]),
        "suite_0gb": lambda: suite.main(["--configs", "0gb"]),
        "verify": lambda: verify_vs_reference.main(
            ["--reference", reference]),
        "gallery": lambda: make_gallery.main(
            ["--out", str(tmp_path / "gallery")]),
    }
    before = sorted(os.listdir(tmp_path))
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        calls[entry]()
    assert sorted(os.listdir(tmp_path)) == before


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


# every launch site and the entry point it calls: (site name, entry, form)
_SITE_ENTRIES = {
    "K5": ("ld_band_count", "ldk_band_count", "FORM_S8"),
    "K1": ("ld_triangle_blocks", "ldk_block_triangle", "FORM_S8"),
    "K1b-bf16": ("ld_triangle_blocks_bf16", "ldk_block_triangle",
                 "FORM_BF16"),
    "K1b-tf32": ("ld_triangle_blocks_tf32", "ldk_block_triangle",
                 "FORM_TF32"),
    "K2": ("ld_triangle_blocks_packed", "ldk_block_triangle", "FORM_BITS"),
    "K3": ("ld_band_sweep_blocks", "ldk_block_sweep", "FORM_S8"),
    "K4": ("ld_band_sweep_blocks_packed", "ldk_block_sweep", "FORM_BITS"),
}


@pytest.mark.parametrize("kernel", sorted(_SITE_ENTRIES))
def test_launches_make_the_tensor_device_current(kernel, monkeypatch):
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
    monkeypatch.setattr(lk, "_sm_count", lambda dev: 132)  # an H100's
    site_name, entry, form_name = _SITE_ENTRIES[kernel]
    site, form = getattr(lk, site_name), getattr(_cuda_build, form_name)
    card1 = torch.device("cuda", 1)
    assert lk._launch(entry, card1, 7, 8) == 0
    assert seen == [(entry, card1, 1001)]
    # the launch sites hand the library call their tensors' device (CPU
    # tensors stand in for the card's here; the guard sees their device)
    seen.clear()
    dtype = torch.uint8 if form == _cuda_build.FORM_BITS else torch.int8
    g = torch.zeros((32, 16), dtype=dtype)
    vec = torch.zeros((32,), dtype=torch.float32)
    cij = torch.zeros((1,), dtype=torch.int32)
    if entry == "ldk_band_count":
        lk._count_launch(site, form, g, vec, vec, vec.to(torch.int32), cij,
                         16, 0, 0.5, sel=0, exact_mask=True, use_dist=False,
                         block_m=16, block_n=16)
    elif entry == "ldk_block_sweep":
        lk._band_sweep_launch(site, form, g, g, vec, vec, vec, vec, cij, 16,
                              outs=("cab",), sel=0, block_m=16, block_n=16)
    else:
        lk._triangle_launch(site, form, g, vec, vec, cij, 16, block_m=16,
                            block_n=16, epilogue="fast", want_dprime=False,
                            out=None)
    assert [(name, dev) for name, dev, _ in seen] == [
        (entry, torch.device("cpu"))]
    assert site.launches == 1
    lk.reset_launches()


def _fake_count_lib(monkeypatch, n_sm=132):
    """A FakeLib for ldk_band_count that records each call's arguments,
    on a faked card of ``n_sm`` SMs."""
    from ld_tools_tpu_torch.ops import _cuda_build
    from ld_tools_tpu_torch.ops import ld_kernels as lk

    calls = []

    class FakeLib:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name, args))
                return 0
            return call

    monkeypatch.setattr(_cuda_build, "lib", lambda: FakeLib())
    monkeypatch.setattr(torch.cuda, "device", _FakeCudaDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=1000))
    monkeypatch.setattr(lk, "_sm_count", lambda dev: n_sm)
    return calls


@pytest.mark.parametrize("n_blocks,block,grid", [
    (1, 16, 1),         # one 128 x 320 tile: one thread block
    (3, 640, 30),       # 10 tiles a block
    (1000, 640, 132),   # more tiles than SMs: one persistent block per SM
    (3, 1000, 96),      # 8 x 4 tiles a block, 96 in all
])
def test_count_launch_passes_the_persistent_grid(n_blocks, block, grid,
                                                 monkeypatch):
    """ld_band_count_kernel walks blocks x tiles in min(SMs, tiles)
    persistent thread blocks: _count_launch hands the library every
    argument of ldk_band_count's prototype, the grid among them, and
    bumps the site's count once."""
    from ld_tools_tpu_torch.ops import _cuda_build
    from ld_tools_tpu_torch.ops import ld_kernels as lk

    calls = _fake_count_lib(monkeypatch)
    lk.reset_launches()
    g = torch.zeros((40, 32), dtype=torch.uint8)
    vec = torch.zeros((40,), dtype=torch.float32)
    cij = torch.zeros((n_blocks,), dtype=torch.int32)
    out = lk._count_launch(lk.ld_band_count_packed, _cuda_build.FORM_BITS, g,
                           vec, vec, vec.to(torch.int32), cij, 5008, 7, 0.5,
                           sel=1, exact_mask=False, use_dist=True,
                           block_m=block, block_n=block)
    assert out.shape == (n_blocks,) and not out.any()
    ((name, args),) = calls
    assert name == "ldk_band_count"
    assert len(args) == len(_cuda_build._SIGNATURES[name])
    (n_blocks_a, n_rows, w, bm, bn, n_hap, _, _, thres, max_dist, sel,
     exact_mask, use_dist, form, grid_a) = args[5:20]
    assert (n_blocks_a, n_rows, w, bm, bn, n_hap) == (n_blocks, 40, 32,
                                                      block, block, 5008)
    assert (thres, max_dist, sel, exact_mask, use_dist, form) == (
        0.5, 7, 1, 0, 1, _cuda_build.FORM_BITS)
    assert grid_a == grid == min(132, lk.count_tiles(n_blocks, block, block))
    assert args[20] == out.data_ptr() and args[21] == 1000
    assert lk.ld_band_count_packed.launches == 1
    lk.reset_launches()


@pytest.mark.parametrize("n_blocks,block,grid", [
    (1, 16, 1),         # one 128 x 256 tile
    (136, 640, 132),    # the headline: 10 tiles of 128 x 320 a block
    (3, 512, 24),       # 4 x 2 tiles of 128 x 256 a block
    (3, 1000, 96),      # 8 x 4 tiles of 128 x 256 a block
])
@pytest.mark.parametrize("kernel", ["K1", "K1b-bf16", "K1b-tf32", "K2",
                                    "K3", "K4"])
def test_block_launch_passes_the_persistent_grid(kernel, n_blocks, block,
                                                 grid, monkeypatch):
    """ld_block_kernel (K1 / K8, K2 and K1b: the triangle; K3, K4: the
    sweep)
    walks blocks x 128 x block_tile_n tiles in min(SMs, tiles) persistent
    thread blocks: the launch hands the library every argument of its
    prototype, the form and the grid among them, and bumps the site's
    count once."""
    from ld_tools_tpu_torch.ops import _cuda_build
    from ld_tools_tpu_torch.ops import ld_kernels as lk

    calls = _fake_count_lib(monkeypatch)
    lk.reset_launches()
    site_name, entry, form_name = _SITE_ENTRIES[kernel]
    site, form = getattr(lk, site_name), getattr(_cuda_build, form_name)
    dtype = torch.uint8 if form == _cuda_build.FORM_BITS else torch.int8
    g = torch.zeros((40, 32), dtype=dtype)
    vec = torch.zeros((40,), dtype=torch.float32)
    cij = torch.zeros((n_blocks,), dtype=torch.int32)
    if entry == "ldk_block_triangle":
        lk._triangle_launch(site, form, g, vec, vec, cij, 16,
                            block_m=block, block_n=block, epilogue="exact",
                            want_dprime=True, out=None)
        at_grid, at_form = 13, 12
    else:
        lk._band_sweep_launch(site, form, g, g, vec, vec,
                              vec, vec, cij, 16, outs=("cab", "meas"), sel=1,
                              block_m=block, block_n=block)
        at_grid, at_form = 17, 16
    ((name, args),) = calls
    assert name == entry
    assert len(args) == len(_cuda_build._SIGNATURES[name])
    assert args[at_form] == form
    assert args[at_grid] == grid == min(
        132, lk.block_tiles(n_blocks, block, block))
    assert args[-1] == 1000 and site.launches == 1
    lk.reset_launches()


@pytest.mark.parametrize("kw,match", [
    (dict(block_m=0, block_n=640), "block_m"),
    (dict(block_m=640, block_n=2049), "block_n"),
    (dict(block_m=640, block_n=640, width=0), "16 bytes"),
])
def test_count_launch_refuses_what_the_kernel_does_not_take(kw, match,
                                                            monkeypatch):
    """A block side outside (0, 2048], rows of no bytes and a tile walk
    past int32 raise before any launch."""
    from ld_tools_tpu_torch.ops import _cuda_build
    from ld_tools_tpu_torch.ops import ld_kernels as lk

    calls = _fake_count_lib(monkeypatch)
    width = kw.pop("width", 16)
    g = torch.zeros((8, width), dtype=torch.int8)
    vec = torch.zeros((8,), dtype=torch.float32)
    cij = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        lk._count_launch(lk.ld_band_count, _cuda_build.FORM_S8, g, vec, vec,
                         vec.to(torch.int32), cij, 16, 0, 0.5, sel=0,
                         exact_mask=True, use_dist=False, **kw)
    with pytest.raises(ValueError, match="int32 tile walk"):
        lk._count_grid(20_000_000, 2048, 2048, torch.device("cpu"))
    assert not calls and lk.ld_band_count.launches == 0


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


def test_mixed_ploidy_scan_raises(tmp_path, monkeypatch):
    """The mixed-ploidy scan (``scan_segments`` over the tool's ploidy
    segments) runs on the CPU when asked; asked for the card with no card
    it raises, and nothing runs on the CPU in its place."""
    import numpy as np

    from ld_tools_tpu_torch.ingest import prep as torch_prep
    from ld_tools_tpu_torch.ingest import synth
    from ld_tools_tpu_torch.tools.common import DataConfig
    from ld_tools_tpu_torch.ops.segment_scan import scan_segments
    from ld_tools_tpu_torch.tools.scan import ScanConfig, ploidy_segments

    d = str(tmp_path)
    rng = np.random.default_rng(77)
    panel = synth.make_panel(8, rng)
    panel[0] = (panel[0][0], panel[0][1], panel[0][2], "male")
    synth.write_panel(os.path.join(d, "samples.txt"), panel)
    GX, hapX = synth.make_chrx_layout(rng, 12, [r[3] for r in panel],
                                      par_bounds=(0.25, 0.75))
    synth.write_vcf(os.path.join(d, "X.vcf.gz"), "X", [r[0] for r in panel],
                    GX, haploid_masks=hapX)
    torch_prep.prep_intgen_data(d)
    data = DataConfig.resolve(d, True, "both", "all")
    cd = data.store().chrom("X")
    segments = ploidy_segments(cd, data.sample_names)
    config = ScanConfig(chroms=("X",), trg_dir_path=d, ld_measure="r_square",
                        ld_low_thres=0.2, max_dist=None)
    assert config.device == "cuda"

    def scan(device):
        return scan_segments(cd.packed, cd.pos, segments,
                             measure=config.ld_measure,
                             thres=config.ld_low_thres, device=device)

    assert scan("cpu").stats["segments"] == 3
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        scan(config.device)


def test_the_scan_tool_reaches_only_the_segment_scan():
    """``tools/scan.py`` leaves the chromosome's scan to
    ``ops/segment_scan.py``: it imports nothing from the engine, the
    kernels' wrappers or the store's packing, and no private name of
    another module of the port, by import or through an imported
    module."""
    below = {"ld_tools_tpu_torch.ops.engine",
             "ld_tools_tpu_torch.ops.ld_kernels",
             "ld_tools_tpu_torch.ingest.pack"}
    with open(os.path.join(PORT_DIR, "tools", "scan.py")) as fh:
        tree = ast.parse(fh.read())
    modules = set()  # names bound to a module of the port
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                assert a.name not in below, a.name
                if a.name.startswith("ld_tools_tpu_torch"):
                    modules.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            assert node.module not in below, node.module
            for a in node.names:
                full = f"{node.module}.{a.name}"
                assert full not in below, full
                if node.module.startswith("ld_tools_tpu_torch"):
                    assert not a.name.startswith("_"), full
                    modules.add(a.asname or a.name)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in modules):
            name = f"{node.value.id}.{node.attr}"
            assert not node.attr.startswith("_"), name


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
