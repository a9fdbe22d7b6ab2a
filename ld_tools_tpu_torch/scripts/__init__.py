"""The port's counterparts of the JAX package's verifier and gallery
scripts:

- ``python -m ld_tools_tpu_torch.scripts.verify_vs_reference --reference
  DIR [-E cuda|torch]``: every tool's values held against a live
  reference checkout's ``backend/calc_ld.py``;
- ``python -m ld_tools_tpu_torch.scripts.make_gallery --out DIR [-E
  cuda|torch]``: the example output files of ``gallery/``, written into
  DIR.

Each runs the port's tools on the card (``-E cuda``, the default) and
raises without one; ``-E torch`` runs the plain PyTorch versions on the
CPU.
"""
