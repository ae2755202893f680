"""The port's `scenarios/p2phandel_scenarios.node_scaling` against the JAX
package's: the CSV text and every seed's final state equal.  One point
a file, as each JAX point compiles a program of its own (about a minute
on the CPU); the ladders are slow-marked in `test_torch_scenarios.py`."""

import pytest
import torch
from test_torch_scenarios import _sweep


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_node_scaling_point_matches_jax(tmp_path):
    """`p2phandel_scenarios.node_scaling` at one point: 36 signers and 7
    relays (the default 40 connections need more than 40 nodes), 2 seeds,
    cities and the city jitter."""
    _sweep(tmp_path, "p2phandel_scenarios", "node_scaling", states=True,
           counts=(36,), seeds=2)
