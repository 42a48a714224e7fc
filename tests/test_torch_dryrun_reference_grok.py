"""The port's dry run against the reference's on grok_1_314b ``train_4k``
at smoke width: fsdp2d, int8 moments, 4 micro-batches (what is held, and
each stated difference with its cause:
``tests/torch_dryrun_reference.py``). A file of its own: its trace takes
half a minute."""
import pytest

from torch_dryrun_reference import (Reference, check_argument_bytes,
                                    check_collectives, check_products,
                                    port_cell)

CELL = ("grok_1_314b", "train_4k", False)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = Reference((CELL,), tmp_path_factory.mktemp("reference"))
    yield ref
    ref.kill()


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    return port_cell(CELL, tmp_path_factory.mktemp("port"))


def test_argument_bytes_equal_the_reference(port, reference):
    check_argument_bytes(port[0], reference[CELL])


def test_product_flops_against_the_reference(port, reference):
    check_products(CELL, *port, reference[CELL])


def test_collective_bytes_by_kind_against_the_reference(port, reference):
    check_collectives(CELL, port[0], reference[CELL])
