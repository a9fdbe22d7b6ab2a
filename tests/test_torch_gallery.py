"""The port's gallery script (ld_tools_tpu_torch/scripts/make_gallery.py)
on the CPU (-E torch) writes every file of the committed gallery/, byte
for byte, into the directory it is given."""

import os

import pytest

from ld_tools_tpu_torch.scripts import make_gallery

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GALLERY = os.path.join(REPO, "gallery")
FILES = sorted(os.listdir(GALLERY))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    out = tmp_path_factory.mktemp("gallery")
    make_gallery.main(["--out", str(out), "-E", "torch"])
    return str(out)


def test_it_writes_the_galleries_files_and_no_other(written):
    assert len(FILES) == 9
    assert sorted(os.listdir(written)) == FILES


@pytest.mark.parametrize("name", FILES)
def test_each_file_is_the_committed_ones(name, written):
    with open(os.path.join(written, name), "rb") as got, open(
            os.path.join(GALLERY, name), "rb") as want:
        assert got.read() == want.read()
