"""The port's live-reference verifier (ld_tools_tpu_torch/scripts/
verify_vs_reference.py) on the CPU (-E torch), against a stand-in
reference checkout whose backend/calc_ld.py wraps tests/oracle.py: no
mismatch; a stand-in off by one value is caught; a missing checkout
exits 2.  Each run is its own process, as a user runs it (the stand-in is
imported as ``backend.calc_ld``)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STAND_IN = "from tests.oracle import oracle_ld as calc_ld\n"

# the third call's r^2 (ld_area's first opponent on chromosome 7) moved by
# one rounding step
OFF_BY_ONE = """\
from tests.oracle import oracle_ld

_calls = [0]


def calc_ld(a, b):
    _calls[0] += 1
    out = oracle_ld(a, b)
    if _calls[0] == 3:
        out["r_square"] = round(out["r_square"] + 0.0001, 4)
    return out
"""


def _reference(tmp_path, source):
    ref = tmp_path / "reference"
    (ref / "backend").mkdir(parents=True)
    (ref / "backend" / "calc_ld.py").write_text(source)
    return str(ref)


def _verify(reference):
    out = subprocess.run(
        [sys.executable, "-m", "ld_tools_tpu_torch.scripts.verify_vs_reference",
         "--reference", reference, "-E", "torch"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=600)
    return out.returncode, out.stdout


def _tally(stdout):
    (line,) = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    return json.loads(line)


def test_a_faithful_reference_gives_no_mismatch(tmp_path):
    code, stdout = _verify(_reference(tmp_path, STAND_IN))
    tally = _tally(stdout)
    assert code == 0, stdout[-3000:]
    assert tally["mismatches"] == 0 and tally["checks_ok"] > 1000
    assert "MISMATCH" not in stdout


def test_a_reference_off_by_one_value_is_caught(tmp_path):
    code, stdout = _verify(_reference(tmp_path, OFF_BY_ONE))
    assert code == 1
    assert _tally(stdout)["mismatches"] == 1
    (line,) = [ln for ln in stdout.splitlines() if ln.startswith("MISMATCH")]
    assert line.startswith("MISMATCH: area r2 ")


def test_a_missing_checkout_exits_2(tmp_path):
    code, stdout = _verify(str(tmp_path / "nowhere"))
    assert code == 2
    assert "reference checkout not found" in stdout
