"""Packed haplotype store: the runtime data plane.

One directory per chromosome under ``<intgen_dir>/tpu_store/``:

  chr<N>/
    gt.npy        uint8 (V, ceil(H/8))  -- bitpacked {0,1} haplotype matrix
    pos.npy       int64 (V,)            -- hg38 positions, ascending
    rsid.npy      unicode (V,)
    ref.npy       unicode (V,)
    alt.npy       unicode (V,)          -- comma-joined ALT alleles
    vt.npy        unicode (V,)          -- comma-joined INFO VT values
    meta.json     {"chrom", "n_variants", "n_haplotypes", "samples": [...]}

This replaces the reference's runtime combination of tabix random access
into VCFs (reference ld_area.py:215-217) and per-record Python genotype
gathering (ld_area.py:230-235): all three workloads become array slicing +
device matmuls over the unpacked matrix.  Bitpacking gives 8x smaller disk
footprint and host->device transfer of int8 after unpack; haplotype columns
are ordered as (sample_0 hapA, sample_0 hapB, sample_1 hapA, ...) in VCF
header sample order.
"""

from __future__ import annotations

import json
import os

import numpy as np

STORE_DIR_NAME = "tpu_store"


def store_root(intgen_dir_path: str) -> str:
    return os.path.join(intgen_dir_path, STORE_DIR_NAME)


def chrom_dir(intgen_dir_path: str, chrom: str) -> str:
    return os.path.join(store_root(intgen_dir_path), f"chr{chrom}")


def is_packed(intgen_dir_path: str, chrom: str) -> bool:
    """Idempotency check: meta.json is written last, so its presence
    marks a complete pack (reference's artifact-existence resumability,
    prep_intgen_data.py:30,83,123,136,147)."""
    return os.path.exists(os.path.join(chrom_dir(intgen_dir_path, chrom), "meta.json"))


def write_chrom(
    intgen_dir_path: str,
    chrom: str,
    genotypes: np.ndarray = None,
    pos: np.ndarray = None,
    rsid=None,
    ref=None,
    alt=None,
    vt=None,
    samples=None,
    genotypes_packed: np.ndarray = None,
    n_haplotypes: int = None,
    pgroup: np.ndarray = None,
    ploidy_profiles: np.ndarray = None,
) -> str:
    """Write one chromosome's packed arrays; atomic via meta-last ordering.

    Pass either ``genotypes`` (int8 (V, H), packed here) or
    ``genotypes_packed`` (uint8 (V, ceil(H/8)) + ``n_haplotypes``) — the
    native scanner emits the packed form directly, so chromosome-scale
    ingest never materializes the unpacked matrix (30+ GB for chr1).

    Mixed-ploidy chromosomes (chrX/chrY — the reference ingests them via
    pysam's ploidy-agnostic GT tuples, prep_intgen_data.py:79-92 +
    ld_area.py:230-235) additionally pass ``pgroup`` ((V,) int16 per-
    variant ploidy-profile ids) and ``ploidy_profiles`` ((P, n_samples)
    uint8 per-sample allele counts per profile).  Omitting both means
    every sample is diploid at every variant, and no sidecar is written.
    """
    d = chrom_dir(intgen_dir_path, chrom)
    os.makedirs(d, exist_ok=True)
    # Re-pack invariant: meta.json is the completion marker, so it must
    # VANISH before any array is rewritten (a crash mid-rewrite with the
    # OLD meta surviving would present mismatched arrays as complete),
    # and a stale pgroup sidecar from a previous mixed-ploidy pack must
    # not outlive an all-diploid re-pack.
    for stale in ("meta.json", "pgroup.npy"):
        try:
            os.remove(os.path.join(d, stale))
        except OSError:
            pass
    if ploidy_profiles is not None:
        profiles = np.ascontiguousarray(ploidy_profiles, dtype=np.uint8)
        if profiles.shape[0] == 1 and (profiles == 2).all():
            pgroup = ploidy_profiles = None  # trivially all-diploid
    if genotypes_packed is not None:
        packed = np.ascontiguousarray(genotypes_packed, dtype=np.uint8)
        n_variants = packed.shape[0]
        assert n_haplotypes is not None
    else:
        genotypes = np.ascontiguousarray(genotypes, dtype=np.uint8)
        n_variants, n_haplotypes = genotypes.shape
        packed = np.packbits(genotypes, axis=1)
    pos_arr = np.asarray(pos, dtype=np.int64)
    if pos_arr.size and np.any(np.diff(pos_arr) < 0):
        # every window/row_at query searchsorts positions; the
        # reference's tabix path REQUIRED a sorted indexed VCF and
        # failed loudly on unsorted input — so must the store
        raise ValueError(
            f"chr{chrom} positions are not ascending; sort the VCF "
            "(bcftools sort) before ingest"
        )
    np.save(os.path.join(d, "gt.npy"), packed)
    np.save(os.path.join(d, "pos.npy"), pos_arr)
    # dtype=str: an empty chromosome would otherwise write float64
    # sidecars, breaking the documented unicode contract
    np.save(os.path.join(d, "rsid.npy"), np.asarray(rsid, dtype=str))
    np.save(os.path.join(d, "ref.npy"), np.asarray(ref, dtype=str))
    np.save(os.path.join(d, "alt.npy"), np.asarray(alt, dtype=str))
    np.save(os.path.join(d, "vt.npy"), np.asarray(vt, dtype=str))
    meta = {
        "chrom": chrom,
        "n_variants": int(n_variants),
        "n_haplotypes": int(n_haplotypes),
        "samples": list(samples),
    }
    if ploidy_profiles is not None:
        np.save(
            os.path.join(d, "pgroup.npy"),
            np.asarray(pgroup, dtype=np.int16),
        )
        meta["ploidy_profiles"] = profiles.tolist()
    tmp = os.path.join(d, "meta.json.tmp")
    with open(tmp, "w") as fh:
        json.dump(meta, fh)
    os.replace(tmp, os.path.join(d, "meta.json"))
    return d


def read_meta(intgen_dir_path: str, chrom: str) -> dict:
    with open(os.path.join(chrom_dir(intgen_dir_path, chrom), "meta.json")) as fh:
        return json.load(fh)


def read_packed(intgen_dir_path: str, chrom: str) -> np.ndarray:
    """The raw bitpacked (V, ceil(H/8)) uint8 matrix, memory-mapped."""
    d = chrom_dir(intgen_dir_path, chrom)
    return np.load(os.path.join(d, "gt.npy"), mmap_mode="r")


def read_genotypes(intgen_dir_path: str, chrom: str, n_haplotypes: int) -> np.ndarray:
    """Unpack gt.npy to an int8 (V, H) matrix."""
    d = chrom_dir(intgen_dir_path, chrom)
    packed = np.load(os.path.join(d, "gt.npy"))
    return np.unpackbits(packed, axis=1, count=n_haplotypes).astype(np.int8)


# popcount-per-byte lookup, for alt-allele counts straight off packed rows
_POPCOUNT8 = np.array([bin(b).count("1") for b in range(256)], dtype=np.uint8)


def popcounts(packed: np.ndarray, chunk_rows: int = 65536) -> np.ndarray:
    """Per-row set-bit counts of a bitpacked (V, B) uint8 matrix.

    Equals the alt-allele counts of the unpacked rows (padding bits are
    zero), without materializing the 8x larger unpacked matrix.
    """
    out = np.empty((packed.shape[0],), dtype=np.int64)
    for s in range(0, packed.shape[0], chunk_rows):
        block = packed[s : s + chunk_rows]
        out[s : s + chunk_rows] = (
            _POPCOUNT8[block].sum(axis=1, dtype=np.int64)
        )
    return out


def pack_columns(
    packed: np.ndarray,
    cols: np.ndarray,
    n_haplotypes: int,
    chunk_rows: int = 16384,
) -> np.ndarray:
    """Repack a haplotype-COLUMN subset of a bitpacked matrix.

    Cohort selection picks bit columns (2i, 2i+1 per sample,
    store.haplotype_columns); a byte matrix cannot be column-sliced at bit
    granularity, so the subset is unpacked and repacked in row chunks —
    O(V*H) once per run, never holding more than chunk_rows unpacked rows.
    Returns (V, ceil(len(cols)/8)) uint8.
    """
    cols = np.asarray(cols, dtype=np.int64)
    v = packed.shape[0]
    out = np.empty((v, -(-len(cols) // 8)), dtype=np.uint8)
    for s in range(0, v, chunk_rows):
        block = np.unpackbits(
            packed[s : s + chunk_rows], axis=1, count=n_haplotypes
        )
        out[s : s + chunk_rows] = np.packbits(block[:, cols], axis=1)
    return out


def unpack_rows(
    packed: np.ndarray, rows: np.ndarray, n_haplotypes: int
) -> np.ndarray:
    """Unpack selected ROWS of a bitpacked matrix to int8 {0,1}."""
    rows = np.asarray(rows, dtype=np.int64)
    return np.unpackbits(
        np.ascontiguousarray(packed[rows]), axis=1, count=n_haplotypes
    ).astype(np.int8)


def read_sidecar(intgen_dir_path: str, chrom: str, name: str) -> np.ndarray:
    return np.load(
        os.path.join(chrom_dir(intgen_dir_path, chrom), f"{name}.npy")
    )


def list_chroms(intgen_dir_path: str) -> list:
    root = store_root(intgen_dir_path)
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        if name.startswith("chr") and os.path.exists(
            os.path.join(root, name, "meta.json")
        ):
            out.append(name[3:])
    return out
