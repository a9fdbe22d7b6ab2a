"""The benchmark's data: a store made from the seed, at the panel's sizes.

Frozen copies of the generators of ``chip_smoke.py`` (``scan_dataset``,
``chrx_dataset``, ``store_panel``, ``write_store``) and of the panel maker
they call (``ld_tools_tpu_torch/ingest/synth.make_panel``), so that a later
change to those files cannot move the yardstick.  Each copy takes its sizes
from a configuration file (``ldbench/configs/<name>.json``) instead of
module constants, and makes its rows on ``device`` with a
``torch.Generator`` of that device.

A dataset is what the reference works from: the packed rows, positions,
ploidy layout and panel.  The store the port reads is written from it by
the port's own ingest (``ingest/pack.write_chrom``), then ``prep`` builds
``conversion.db``; no VCF text is written.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

# after ld_tools_tpu_torch/ingest/synth.py: POPS
POPS = {
    "EUR": ["GBR", "FIN", "IBS", "TSI", "CEU"],
    "EAS": ["CHB", "JPT", "CHS", "CDX", "KHV"],
    "AFR": ["YRI", "LWK", "GWD", "MSL", "ESN", "ASW", "ACB"],
    "AMR": ["MXL", "PUR", "CLM", "PEL"],
    "SAS": ["GIH", "PJL", "BEB", "STU", "ITU"],
}
RSID_BASE = 100_000  # row k of a store is rs{RSID_BASE + k}
ROW_CHUNK = 65_536   # rows made on the device at a time
STRATA = 10          # runs a stratum of a frequency mixture spans


@dataclasses.dataclass
class Dataset:
    """One chromosome as generated: ``gp`` (V, ceil(H/8)) packed rows in
    the store's column order (sample i at columns 2i, 2i+1; a haploid
    cell's second column is 0), ``pos`` ascending unique positions,
    ``pgroup`` (V,) ploidy profile of each row and ``profiles`` (P, S)
    alleles per sample and profile (both None: all diploid), ``panel``
    [(name, pop, super_pop, gender)] in store order."""

    chrom: str
    gp: np.ndarray
    pos: np.ndarray
    n_hap: int
    panel: list
    pgroup: np.ndarray = None
    profiles: np.ndarray = None

    @property
    def n_variants(self) -> int:
        return int(self.gp.shape[0])

    def rsid(self, rows) -> list:
        return [f"rs{RSID_BASE + int(r)}" for r in np.asarray(rows).ravel()]


def make_panel(n_samples: int, rng) -> list:
    """Copy of ld_tools_tpu_torch/ingest/synth.make_panel: [(name, pop,
    super_pop, gender)] round-robined over populations."""
    flat = [(pop, sup) for sup, pops in POPS.items() for pop in pops]
    rows = []
    for i in range(n_samples):
        pop, sup = flat[i % len(flat)]
        gender = "male" if rng.random() < 0.5 else "female"
        rows.append((f"SYN{i:05d}", pop, sup, gender))
    return rows


def store_panel(n_samples: int, seed: int) -> list:
    """Copy of chip_smoke.store_panel: the panel of a store made with
    ``seed``."""
    return make_panel(n_samples, np.random.default_rng(seed))


def scan_dataset(v, n_hap, seed, *, run, flip, freq, span, first_pos,
                 device):
    """Copy of chip_smoke.scan_dataset: runs of ``run`` identical rows
    (allele frequency uniform in ``freq`` = [lo, hi], or from the mixture
    of bands [[lo, hi, weight], ...], :func:`_stratified_freq`) with
    ``flip`` flip noise, unique positions uniform over ``span`` bp from
    ``first_pos``; the packed
    bytes.  Made on ``device`` in row chunks, so a chromosome-scale store
    never needs its int8 matrix on the host."""
    import torch

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    weights = 2 ** torch.arange(7, -1, -1, device=dev, dtype=torch.int32)
    w = -(-n_hap // 8)
    gp = np.empty((v, w), dtype=np.uint8)
    rows = (ROW_CHUNK // run) * run
    run_freq = None
    if isinstance(freq[0], (list, tuple)):
        run_freq = _stratified_freq(-(-v // run), freq, gen, dev)
    for lo in range(0, v, rows):
        n = min(rows, v - lo)
        n_runs = -(-n // run)
        if run_freq is None:
            f = freq[0] + (freq[1] - freq[0]) * torch.rand(
                (n_runs, 1), generator=gen, device=dev)
        else:
            f = run_freq[lo // run:lo // run + n_runs, None]
        base = torch.rand((n_runs, n_hap), generator=gen, device=dev) < f
        g = base.repeat_interleave(run, dim=0)[:n]
        g ^= torch.rand((n, n_hap), generator=gen, device=dev) < flip
        if w * 8 > n_hap:
            g = torch.nn.functional.pad(g, (0, w * 8 - n_hap))
        bits = g.view(n, w, 8).to(torch.int32)
        gp[lo:lo + n] = (bits * weights).sum(dim=2).to(torch.uint8).cpu().numpy()
        del f, base, g, bits
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.choice(span, size=v, replace=False)).astype(np.int64)
    return gp, pos + first_pos


def _stratified_freq(n_runs, bands, gen, dev, strata=STRATA):
    """Each run's allele frequency from the mixture of ``bands`` [[lo, hi,
    weight], ...], stratified: every ``strata`` consecutive runs take one
    draw from each of ``strata`` equal slices of the mixture's quantiles,
    in an order drawn from the seed, so that every seed makes the same
    shares of each band along the chromosome and the work does not move
    with the seed."""
    import torch

    n_groups = -(-n_runs // strata)
    order = torch.rand((n_groups, strata), generator=gen,
                       device=dev).argsort(dim=1)
    u = (order + torch.rand((n_groups, strata), generator=gen, device=dev))
    u = (u / strata).flatten()[:n_runs]
    w = torch.tensor([b[2] for b in bands], device=dev, dtype=torch.float64)
    cum = torch.cumsum(w / w.sum(), 0)
    band = torch.clamp(torch.searchsorted(cum, u.double(), right=True), 0,
                       len(bands) - 1)
    start = torch.cat([torch.zeros(1, device=dev, dtype=torch.float64),
                       cum[:-1]])
    frac = ((u.double() - start[band]) / (cum[band] - start[band])).float()
    lo = torch.tensor([b[0] for b in bands], device=dev)
    hi = torch.tensor([b[1] for b in bands], device=dev)
    return lo[band] + (hi[band] - lo[band]) * frac


def make_dataset(config: dict, seed: int, device: str) -> Dataset:
    """The configuration's chromosome from ``seed``: :func:`scan_dataset`,
    and where the configuration has a PAR1 bound, the mixed-ploidy layout
    of :func:`chrx_layout`."""
    n_samples = int(config["n_samples"])
    n_hap = 2 * n_samples
    gp, pos = scan_dataset(
        int(config["n_variants"]), n_hap, seed, run=int(config["ld_run_rows"]),
        flip=float(config["flip"]), freq=config["freq"],
        span=int(config["span_bp"]), first_pos=int(config["first_pos"]),
        device=device)
    panel = store_panel(n_samples, seed)
    ds = Dataset(chrom=str(config["chrom"]), gp=gp, pos=pos, n_hap=n_hap,
                 panel=panel)
    if config.get("par1_end") is not None:
        chrx_layout(ds, int(config["par1_end"]), int(config["straddle_rows"]))
    return ds


def chrx_layout(ds: Dataset, par1_end: int, straddle: int) -> None:
    """After chip_smoke.chrx_dataset, moved to the one PAR1 bound: every
    male is haploid past ``par1_end`` (his second column zeroed), as
    ploidy profile 1 (profile 0: all diploid).  The reference pairs a PAR
    row's list with a non-PAR row's by zip truncation (calc_ld.py:30-33),
    so the first ``straddle`` rows past the bound carry, in their
    profile's columns, the leading alleles of the last PAR row: those
    pairs are in LD across the bound."""
    male = np.array([row[3] == "male" for row in ds.panel])
    n_samples = male.size
    lo = int(np.searchsorted(ds.pos, par1_end, side="right"))
    profiles = np.full((2, n_samples), 2, dtype=np.uint8)
    profiles[1, male] = 1
    pgroup = np.zeros(ds.n_variants, dtype=np.int16)
    pgroup[lo:] = 1
    live = np.ones(ds.gp.shape[1] * 8, dtype=bool)
    live[2 * np.flatnonzero(male) + 1] = False
    live[ds.n_hap:] = False
    ds.gp[lo:] &= np.packbits(live.astype(np.uint8))
    cols = np.flatnonzero(live)
    if 0 < lo < ds.n_variants:
        full = np.zeros(live.size, dtype=np.uint8)
        full[cols] = np.unpackbits(ds.gp[lo - 1], count=ds.n_hap)[:cols.size]
        ds.gp[lo:lo + straddle] = np.packbits(full)
    ds.pgroup, ds.profiles = pgroup, profiles


def write_store(d: str, ds: Dataset, rows=None) -> None:
    """Copy of chip_smoke.write_store: samples.txt + the packed store,
    written by the port's ingest, so that prep builds conversion.db
    offline.  ``rows`` (a slice) writes only those rows."""
    from ld_tools_tpu_torch.ingest import pack

    sl = slice(None) if rows is None else rows
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "samples.txt"), "w") as fh:
        fh.write("sample\tpop\tsuper_pop\tgender\n")
        for row in ds.panel:
            fh.write("\t".join(row) + "\n")
    idx = np.arange(ds.n_variants)[sl]
    v = idx.size
    mixed = ds.pgroup is not None and np.unique(ds.pgroup[sl]).size > 1
    pack.write_chrom(
        d, ds.chrom, pos=ds.pos[sl], rsid=ds.rsid(idx), ref=["A"] * v,
        alt=["G"] * v, vt=["SNP"] * v, samples=[row[0] for row in ds.panel],
        genotypes_packed=ds.gp[sl], n_haplotypes=ds.n_hap,
        pgroup=ds.pgroup[sl] if mixed else None,
        ploidy_profiles=ds.profiles if mixed else None,
    )


def prepare_store(d: str, ds: Dataset, rows=None) -> str:
    """:func:`write_store`, then the port's prep (conversion.db: samples,
    variants and the rsID index); returns ``d``."""
    from ld_tools_tpu_torch.ingest import prep_intgen_data

    write_store(d, ds, rows)
    prep_intgen_data(d)
    return d
