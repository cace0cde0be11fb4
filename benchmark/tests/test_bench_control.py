"""Each cell's control, at CPU sizes: the reference in the program's place
at the precision below the configuration's comes out not correct."""
import pytest

from benchmark import control, harness
from benchmark.tests.tiny import tiny_root

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(root, cell):
    for line in control.main(["--workload", cell, "--seeds", "11", "12"],
                             root=root, device="cpu"):
        assert line["fails"], line
