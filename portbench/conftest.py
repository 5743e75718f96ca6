"""Small shapes of the benchmark's cells for the CPU tests."""
import pytest
import torch

from portbench import graph, harness

SMALL = {
    "g500_ic.imm": dict(scale=8, edgefactor=8, max_theta=1024, k=6,
                        check_per_word=2),
    "g500_lt.imm": dict(scale=8, edgefactor=4, max_theta=1024, k=6),
    "g500_lt.serve": dict(scale=8, edgefactor=4),
}
SMALL_TRAFFIC = {"g500_lt.serve": dict(queries=48, k_max=8, check_queries=48,
                                       pool_theta=256, slab=64)}
KRONECKER = dict(generator="kronecker", A=0.57, B=0.19, C=0.19, p_max=0.1)


def small_graph(scale: int, edgefactor: int, seed: int):
    """A Graph500 Kronecker graph of 2^scale vertices from the seed."""
    return graph.make(dict(KRONECKER, scale=scale, edgefactor=edgefactor,
                           graph_seed=seed))


def small_cell(name: str, **config) -> harness.Cell:
    cell = harness.Cell(name, harness.load_json(harness.ROOT /
                                                "BENCHMARK.json"))
    cell.config.update(SMALL[name], **config)
    cell.traffic.update(SMALL_TRAFFIC.get(name, {}))
    return cell


@pytest.fixture(params=sorted(SMALL))
def cell_name(request):
    return request.param


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread in these tests: the suite runs beside other
    workers, and many small CPU ops on every core oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
