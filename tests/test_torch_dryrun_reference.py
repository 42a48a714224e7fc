"""The port's dry run against the reference's on three smoke cells:
qwen3_8b ``train_4k``, gemma3_12b ``decode_32k`` on two pods and
mamba2_130m ``prefill_32k`` (what is held, and each stated difference with
its cause: ``tests/torch_dryrun_reference.py``)."""
import pytest

from torch_dryrun_reference import (Reference, check_argument_bytes,
                                    check_collectives, check_products,
                                    port_cell)

CELLS = (("qwen3_8b", "train_4k", False),
         ("gemma3_12b", "decode_32k", True),
         ("mamba2_130m", "prefill_32k", False))
IDS = ["/".join(map(str, c)) for c in CELLS]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = Reference(CELLS, tmp_path_factory.mktemp("reference"))
    yield ref
    ref.kill()


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    """The port's records, traced while the reference compiles."""
    tmp = tmp_path_factory.mktemp("port")
    return {c: port_cell(c, tmp) for c in CELLS}


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_argument_bytes_equal_the_reference(cell, port, reference):
    check_argument_bytes(port[cell][0], reference[cell])


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_product_flops_against_the_reference(cell, port, reference):
    check_products(cell, *port[cell], reference[cell])


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_collective_bytes_by_kind_against_the_reference(cell, port,
                                                        reference):
    check_collectives(cell, port[cell][0], reference[cell])
