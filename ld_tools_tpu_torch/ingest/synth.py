"""Synthetic phased-VCF + sample-panel generators.

The reference's data source (1000 Genomes FTP) is dead (reference
README.md:2) and test/bench environments have no egress, so every test and
benchmark here runs on generated data: a panel file and per-chromosome
bgzip-compatible ``.vcf.gz`` tables with phased biallelic genotypes, plus
optional records that must be filtered out (non-rs IDs, MULTI_ALLELIC,
duplicate (CHROM, POS, ID) runs) to exercise ingest semantics
(reference backend/prep_intgen_data.py:163-176).
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib

import numpy as np

POPS = {
    "EUR": ["GBR", "FIN", "IBS", "TSI", "CEU"],
    "EAS": ["CHB", "JPT", "CHS", "CDX", "KHV"],
    "AFR": ["YRI", "LWK", "GWD", "MSL", "ESN", "ASW", "ACB"],
    "AMR": ["MXL", "PUR", "CLM", "PEL"],
    "SAS": ["GIH", "PJL", "BEB", "STU", "ITU"],
}


def make_panel(n_samples: int, rng) -> list:
    """[(name, pop, super_pop, gender)] round-robined over populations."""
    flat = [(pop, sup) for sup, pops in POPS.items() for pop in pops]
    rows = []
    for i in range(n_samples):
        pop, sup = flat[i % len(flat)]
        gender = "male" if rng.random() < 0.5 else "female"
        rows.append((f"SYN{i:05d}", pop, sup, gender))
    return rows


def write_panel(path: str, panel_rows) -> None:
    with open(path, "w") as fh:
        fh.write("sample\tpop\tsuper_pop\tgender\n")
        for row in panel_rows:
            fh.write("\t".join(row) + "\n")


class BgzfWriter:
    """Minimal BGZF (blocked gzip) writer.

    The real 1000G VCFs are bgzip-compressed: a sequence of independent
    gzip members of <=65,280 uncompressed bytes, each carrying its own
    compressed size in a "BC" extra subfield, terminated by a fixed
    28-byte empty member.  Writing fixtures in this format lets tests and
    benches exercise the native scanner's block-parallel path
    (native/vcfpack.cpp vp_scan_mt); gzip.open / gzread read it
    transparently as multi-member gzip.
    """

    MAX_BLOCK = 65280
    EOF_MARKER = bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000"
    )

    def __init__(self, fh, level: int = 6):
        self._fh = fh
        self._level = level
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= self.MAX_BLOCK:
            self._emit(bytes(self._buf[: self.MAX_BLOCK]))
            del self._buf[: self.MAX_BLOCK]

    def close(self) -> None:
        if self._buf:
            self._emit(bytes(self._buf))
            self._buf.clear()
        self._fh.write(self.EOF_MARKER)

    def _emit(self, chunk: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        bsize = 12 + 6 + len(cdata) + 8  # header + BC subfield + payload + crc/isize
        header = (
            b"\x1f\x8b\x08\x04" + b"\x00" * 6
            + struct.pack("<H", 6)
            + b"BC" + struct.pack("<HH", 2, bsize - 1)
        )
        footer = struct.pack("<II", zlib.crc32(chunk), len(chunk) & 0xFFFFFFFF)
        self._fh.write(header + cdata + footer)


def _genotype_line_bytes(row: np.ndarray, haploid=None) -> bytes:
    """'a|b\\tc|d...' for one variant row of 2S haplotypes, vectorized.

    ``haploid`` ((S,) bool) marks samples whose cell is written as the
    single allele ``row[2*s]`` — the layout real 1000G chrX non-PAR /
    chrY rows have for males.
    """
    n_samples = row.shape[0] // 2
    if haploid is not None and np.any(haploid):
        parts = []
        for s in range(n_samples):
            if haploid[s]:
                parts.append(chr(ord("0") + int(row[2 * s])))
            else:
                parts.append(
                    f"{int(row[2 * s])}|{int(row[2 * s + 1])}"
                )
        return "\t".join(parts).encode()
    cells = np.empty((n_samples, 4), dtype=np.uint8)
    cells[:, 0] = row[0::2] + ord("0")
    cells[:, 1] = ord("|")
    cells[:, 2] = row[1::2] + ord("0")
    cells[:, 3] = ord("\t")
    return cells.tobytes()[:-1]


def correlated_haplotypes(
    rng, n_variants: int, n_haplotypes: int, decay: float = 0.9
):
    """{0,1} matrix with LD structure: each variant copies its predecessor's
    haplotype vector with per-haplotype flip probability (1 - decay)/2,
    giving realistic LD decay along the variant axis."""
    G = np.empty((n_variants, n_haplotypes), dtype=np.int8)
    freq = rng.uniform(0.05, 0.95)
    G[0] = rng.random(n_haplotypes) < freq
    for i in range(1, n_variants):
        if rng.random() < 0.1:  # occasional LD-block boundary
            freq = rng.uniform(0.05, 0.95)
            G[i] = rng.random(n_haplotypes) < freq
        else:
            flips = rng.random(n_haplotypes) < (1 - decay) / 2
            G[i] = np.where(flips, 1 - G[i - 1], G[i - 1])
    return G


def write_vcf(
    path: str,
    chrom: str,
    sample_names,
    genotypes: np.ndarray,
    pos=None,
    rsids=None,
    extra_records=(),
    rng=None,
    pos_step: int = 1000,
    bgzf: bool = True,
    bgzf_block: int | None = None,
    haploid_masks: np.ndarray = None,
) -> dict:
    """Write a phased biallelic VCF(.gz); returns {rsid: pos}.

    ``extra_records`` entries are (sort_pos, raw_vcf_line) for injecting
    records that ingest must filter out.  ``.gz`` paths are written as
    BGZF (like real 1000G files) unless ``bgzf=False`` requests plain
    single-member gzip; ``bgzf_block`` shrinks the block size to force
    records to span block/batch boundaries in tests.

    ``haploid_masks`` ((V, S) bool) writes marked cells as single-allele
    haploid genotypes (chrX non-PAR / chrY males); the corresponding
    ``genotypes[i, 2*s+1]`` columns should be zero (they are ignored).
    """
    n_variants, n_hap = genotypes.shape
    assert n_hap == 2 * len(sample_names)
    if pos is None:
        pos = (np.arange(n_variants, dtype=np.int64) + 1) * pos_step
    if rsids is None:
        rsids = [f"rs{int(p)}" for p in pos]
    alleles = [("A", "G"), ("C", "T"), ("G", "A"), ("T", "C")]

    lines = []
    for i in range(n_variants):
        ref, alt = alleles[i % len(alleles)]
        head = (
            f"{chrom}\t{int(pos[i])}\t{rsids[i]}\t{ref}\t{alt}\t100\tPASS\t"
            f"VT=SNP\tGT\t"
        ).encode()
        hap = None if haploid_masks is None else haploid_masks[i]
        lines.append((
            int(pos[i]), i,
            head + _genotype_line_bytes(genotypes[i], haploid=hap),
        ))
    for sort_pos, raw in extra_records:
        lines.append((sort_pos, len(lines), raw.encode()))
    lines.sort(key=lambda t: (t[0], t[1]))

    is_gz = str(path).endswith(".gz")
    if is_gz and bgzf:
        with open(path, "wb") as raw_fh:
            writer = BgzfWriter(raw_fh)
            if bgzf_block is not None:
                writer.MAX_BLOCK = bgzf_block
            writer.write(b"##fileformat=VCFv4.1\n")
            writer.write(b"##source=ld_tools_tpu_torch.ingest.synth\n")
            header = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            writer.write(
                header.encode() + "\t".join(sample_names).encode() + b"\n"
            )
            for _, _, line in lines:
                writer.write(line + b"\n")
            writer.close()
        return {rsids[i]: int(pos[i]) for i in range(n_variants)}

    opener = gzip.open if is_gz else open
    with opener(path, "wb") as fh:
        fh.write(b"##fileformat=VCFv4.1\n")
        fh.write(b"##source=ld_tools_tpu_torch.ingest.synth\n")
        header = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        fh.write(header.encode() + "\t".join(sample_names).encode() + b"\n")
        for _, _, line in lines:
            fh.write(line + b"\n")
    return {rsids[i]: int(pos[i]) for i in range(n_variants)}


def raw_record(
    chrom, pos, rsid, genotype_row, ref="A", alt="G", info="VT=SNP"
) -> str:
    """A raw VCF line for extra_records (filter-exercise fixtures)."""
    gts = _genotype_line_bytes(np.asarray(genotype_row, dtype=np.int8)).decode()
    return f"{chrom}\t{pos}\t{rsid}\t{ref}\t{alt}\t100\tPASS\t{info}\tGT\t{gts}"


def generate_dataset(
    intgen_dir: str,
    n_samples: int = 50,
    chrom_variant_counts: dict = None,
    seed: int = 0,
    with_filtered_records: bool = False,
):
    """Full synthetic data directory: samples.txt + per-chrom VCF.gz.

    Returns {chrom: {rsid: pos}}.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(intgen_dir, exist_ok=True)
    panel = make_panel(n_samples, rng)
    write_panel(os.path.join(intgen_dir, "samples.txt"), panel)
    sample_names = [row[0] for row in panel]
    chrom_variant_counts = chrom_variant_counts or {"1": 60, "2": 40}

    out = {}
    rs_counter = 10001  # globally unique rsIDs across chromosomes
    for chrom, n_variants in chrom_variant_counts.items():
        G = correlated_haplotypes(rng, n_variants, 2 * n_samples)
        rsids = [f"rs{rs_counter + i}" for i in range(n_variants)]
        rs_counter += n_variants
        extra = []
        if with_filtered_records:
            row = G[0]
            extra = [
                (15, raw_record(chrom, 15, "esv990381", row)),
                (25, raw_record(chrom, 25, "rs77777777", row,
                                info="VT=SNP;MULTI_ALLELIC")),
                # duplicate-triple run: both records must vanish
                (35, raw_record(chrom, 35, "rs88888888", row)),
                (35, raw_record(chrom, 35, "rs88888888", row, alt="T")),
            ]
        out[chrom] = write_vcf(
            os.path.join(intgen_dir, f"{chrom}.vcf.gz"),
            chrom,
            sample_names,
            G,
            rsids=rsids,
            extra_records=extra,
            rng=rng,
        )
    return out


def make_chrx_layout(rng, n_variants: int, genders, par_bounds=(0.25, 0.75)):
    """chrX-like genotype layout: males haploid outside the PAR bands.

    Real 1000G chrX rows are diploid for everyone inside the
    pseudoautosomal regions and haploid for males elsewhere (the
    reference ingests whatever pysam hands it, ld_area.py:230-235).
    Returns ``(G, haploid_masks)``: G is (V, 2S) int8 in the packed
    store's full layout (haploid male cells carry their allele at column
    2*s with column 2*s+1 zeroed), haploid_masks is the (V, S) bool mask
    for write_vcf.  ``par_bounds`` are variant-index fractions marking
    the PAR1|non-PAR|PAR2 boundaries.
    """
    n_samples = len(genders)
    G = correlated_haplotypes(rng, n_variants, 2 * n_samples)
    male = np.asarray([g == "male" for g in genders])
    lo = int(par_bounds[0] * n_variants)
    hi = int(par_bounds[1] * n_variants)
    haploid_masks = np.zeros((n_variants, n_samples), dtype=bool)
    haploid_masks[lo:hi, male] = True
    # zero the dead second-haplotype columns of haploid cells so the
    # full-layout matrix matches what ingest reconstructs
    dead_cols = 2 * np.flatnonzero(male) + 1
    G[lo:hi][:, dead_cols] = 0
    return G, haploid_masks
