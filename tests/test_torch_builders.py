"""The port's node builders (`wittgenstein_tpu_torch/core/builders.py`)
against the JAX package's `NodeBuilder.build`, field for field: the city
placement (population-weighted, a float32 cumulative share searched
with the float32 draw) and the AWS placement, with and without the Tor
aspect, at 64-1,024 nodes and three seeds; and the vendored city
database, a byte-for-byte copy of the JAX package's."""

import filecmp
import os

import numpy as np
import pytest
import torch

from wittgenstein_tpu_torch.core import builders, geo

FIELDS = ("x", "y", "city", "speed_ratio", "extra_latency", "down",
          "byzantine")


@pytest.mark.parametrize("location", ["cities", "aws"])
@pytest.mark.parametrize("n", [64, 333, 1024])
def test_placements_match_jax(location, n):
    from wittgenstein_tpu.core import builders as jbuilders
    for seed in (0, 1, 7):
        for tor in (0.0, 0.33):
            want = jbuilders.NodeBuilder(location=location,
                                         tor=tor).build(seed, n)
            got = builders.NodeBuilder(location=location, tor=tor).build(
                torch.tensor(seed, dtype=torch.int32), n, "cpu")
            for k in FIELDS:
                assert np.array_equal(np.asarray(getattr(want, k)),
                                      getattr(got, k).numpy()), (seed, k)
    assert len(np.unique(got.city.numpy())) > 3


def test_city_data_is_the_jax_packages():
    import wittgenstein_tpu
    theirs = os.path.join(os.path.dirname(wittgenstein_tpu.__file__),
                          "data", "citydata.npz")
    assert filecmp.cmp(theirs, geo.NPZ, shallow=False)
    db = geo.load()
    assert db.n == len(db.x) == db.rtt.shape[0] > 100
