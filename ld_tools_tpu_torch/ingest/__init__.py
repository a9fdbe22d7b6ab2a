from ld_tools_tpu_torch.ingest.store import HaplotypeStore, ChromData
from ld_tools_tpu_torch.ingest.prep import prep_intgen_data
from ld_tools_tpu_torch.ingest.cohort import get_sample_names
from ld_tools_tpu_torch.ingest.src_dict import create_src_dict

__all__ = [
    "HaplotypeStore",
    "ChromData",
    "prep_intgen_data",
    "get_sample_names",
    "create_src_dict",
]
