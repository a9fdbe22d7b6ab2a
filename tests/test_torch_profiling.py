"""The port's profiling helpers (utils/profiling.py) and batch slicing
(parallel/batch.py) against the JAX package's."""

import json
import os
import time

import pytest
import torch

from ld_tools_tpu.parallel import batch as jax_batch
from ld_tools_tpu.utils import profiling as jp
from ld_tools_tpu_torch.parallel.batch import chromosomes_for_this_process
from ld_tools_tpu_torch.utils import profiling as tp

ROOFLINES = [
    # (n_pairs, padded haplotypes, bytes, int8, seconds)
    (52_433_920.0, 5120, 720_896_000.0, True, 1.3e-3),   # the headline
    (52_433_920.0, 5120, 720_896_000.0, False, 1.3e-3),
    (1.0, 2, 3.35e12, False, 2.0),                        # memory bound
    (1e9, 500, 1e6, True, 7e-4),
]


def test_h100_peaks():
    assert tp.CHIP_PEAKS == {"h100": (989.0, 3350.0, 2.0)}


@pytest.mark.parametrize("pairs,h_pad,nbytes,int8,seconds", ROOFLINES)
def test_roofline_matches_jax(monkeypatch, pairs, h_pad, nbytes, int8,
                              seconds):
    monkeypatch.setitem(jp.CHIP_PEAKS, "h100", tp.CHIP_PEAKS["h100"])
    kw = dict(n_pairs=pairs, n_haplotypes_padded=h_pad, bytes_moved=nbytes,
              chip="h100", int8_mxu=int8)
    want = jp.Roofline(**kw).achieved(seconds)
    got = tp.Roofline(**kw).achieved(seconds)
    assert got == want
    assert tp.Roofline(**kw).flops == jp.Roofline(**kw).flops


def test_roofline_refuses_unknown_chips():
    with pytest.raises(KeyError):
        tp.Roofline(n_pairs=1.0, n_haplotypes_padded=1, bytes_moved=1.0,
                    chip="v5e").achieved(1.0)
    with pytest.raises(TypeError):  # no default chip
        tp.Roofline(n_pairs=1.0, n_haplotypes_padded=1, bytes_moved=1.0)


def _card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM5"])
def test_detect_chip_names_an_h100(monkeypatch, name):
    _card(monkeypatch, name)
    assert tp.detect_chip() == "h100"


@pytest.mark.parametrize("name", ["NVIDIA H100 PCIe", "NVIDIA H100 NVL",
                                  "NVIDIA A100-SXM4-80GB", "TPU v5 lite", ""])
def test_detect_chip_raises_for_unknown_cards(monkeypatch, name):
    _card(monkeypatch, name)
    with pytest.raises(ValueError, match="no published peaks"):
        tp.detect_chip()


def test_detect_chip_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tp.detect_chip()


class _FakeClock:
    """A timer that runs the work and reports a scripted time: each call
    of fn(datasets, seed) costs ``base + per_sweep * n`` plus ``noise``
    per seed, so the expected result is known."""

    def __init__(self, base, per_sweep, noise):
        self.base, self.per_sweep, self.noise = base, per_sweep, noise
        self.calls = []

    def make_many(self, n):
        def fn(datasets, seed):
            self.calls.append((n, seed))
            self.last = self.base + self.per_sweep * n + self.noise(seed)
        return fn

    def timer(self, run):
        run()
        return self.last


def test_sweep_seconds_differences_the_best_runs():
    clock = _FakeClock(0.5, 1e-3, noise=lambda seed: 0.01 * (seed % 3))
    dt, times = tp.sweep_seconds(clock.make_many, [], n_lo=4, n_hi=20,
                                 trials=3, seed_base=6.0, timer=clock.timer)
    # one untimed run (seed 0), then trials with seeds 7, 8, 9 per count
    assert clock.calls == [(4, 0.0), (4, 7.0), (4, 8.0), (4, 9.0),
                           (20, 0.0), (20, 7.0), (20, 8.0), (20, 9.0)]
    # the minimum over the timed runs: seed 9 (noise 0)
    assert times == {4: pytest.approx(0.504), 20: pytest.approx(0.52)}
    assert dt == pytest.approx(1e-3)


def test_sweep_seconds_rejects_a_non_positive_difference():
    clock = _FakeClock(0.5, 0.0, noise=lambda seed: 0.0)
    with pytest.warns(UserWarning, match="non-positive"):
        dt, times = tp.sweep_seconds(clock.make_many, [], timer=clock.timer)
    assert dt != dt  # NaN
    assert times[4] == times[12] == 0.5


def test_sweep_seconds_times_cpu_tensors_on_the_host_clock(monkeypatch):
    used = []

    def host(run):
        used.append("host")
        run()
        return 1.0 + len(used)  # grows: a positive difference

    def card(run):
        raise AssertionError("CUDA events for CPU tensors")

    monkeypatch.setattr(tp, "host_seconds", host)
    monkeypatch.setattr(tp, "cuda_event_seconds", card)
    dt, _ = tp.sweep_seconds(lambda n: (lambda datasets, seed: None),
                             [(torch.zeros(4), torch.ones(4))], trials=1)
    assert used == ["host"] * 4 and dt > 0


def test_host_seconds_reads_the_host_clock():
    assert tp.host_seconds(lambda: time.sleep(2e-3)) >= 2e-3


def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_LD_PROFILE_DIR", str(tmp_path))
    with tp.maybe_trace():
        torch.ones(8).sum()
    (name,) = os.listdir(tmp_path)
    assert name.startswith(f"trace_{os.getpid()}_") and name.endswith(".json")
    with open(tmp_path / name) as fh:
        assert "traceEvents" in json.load(fh)


def test_chromosomes_one_process_takes_all():
    chroms = [str(c) for c in range(1, 23)] + ["X"]
    assert chromosomes_for_this_process(chroms) == chroms
    assert chromosomes_for_this_process(iter(chroms)) == chroms
    assert jax_batch.chromosomes_for_this_process(chroms) == chroms


@pytest.mark.parametrize("world,rank", [(2, 0), (3, 1), (4, 3)])
def test_chromosomes_round_robin_by_rank(monkeypatch, world, rank):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(jax_batch.jax, "process_count", lambda: world)
    monkeypatch.setattr(jax_batch.jax, "process_index", lambda: rank)
    chroms = [str(c) for c in range(1, 9)]
    got = chromosomes_for_this_process(chroms)
    assert got == jax_batch.chromosomes_for_this_process(chroms)
    assert got == chroms[rank::world]
