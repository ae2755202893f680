"""The port's node builders (`wittgenstein_tpu_torch/core/builders.py`)
against the JAX package's `NodeBuilder.build`, field for field: the city
placement (population-weighted, a float32 cumulative share searched
with the float32 draw) and the AWS placement, with and without the Tor
aspect, at 64-1,024 nodes and three seeds; every registry name; the
vendored city database, a byte-for-byte copy of the JAX package's; the
speed models over every value of their 2^24-point draw grid, the
shipped pareto fixes regenerated; and Handel with uniform speed, leaf
for leaf."""

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


# ------------------------------------------------------------ speeds

SPEED_CASES = [("uniform", False), ("uniform", True), ("gaussian", False),
               ("pareto", False)]


@pytest.mark.parametrize("speed,slow", SPEED_CASES)
def test_speed_ratios_exhaustive(speed, slow):
    """Every value of the builder's draw (its 2^24-point grid): the
    port's speed ratio equal to the JAX package's as its `init`
    computes it (op by op), bit for bit; for the uniform model the grid
    is ``u2``'s, on the fast half and on the slow one."""
    import torch_parity as tp
    want = tp.jax_speed_grid(speed, slow).view(np.int32)
    grid = torch.tensor(tp.speed_grid())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for part in torch.split(torch.arange(len(grid)), 1 << 22):
            u = grid[part]
            if speed == "uniform":
                got = builders.speed_ratio(
                    speed, torch.full_like(u, 0.75 if slow else 0.25), u)
            else:
                got = builders.speed_ratio(speed, u)
            bad = np.nonzero(got.numpy().view(np.int32) !=
                             want[part.numpy()])[0]
            assert not len(bad), (
                f"{speed}: {len(bad)} grid values differ in this part, "
                f"first u = {float(u[bad[0]])}")
    finally:
        torch.set_num_threads(threads)


def test_pareto_fixes_match_jax():
    """The shipped pareto fixes, regenerated from the JAX function."""
    import torch_parity as tp
    assert np.array_equal(tp.jax_pareto_fixes(),
                          np.load(builders._PARETO_FILE))


def test_every_registry_name_matches_jax():
    """Every builder registry name (with the reference's quirk: a
    GAUSSIAN name builds uniform speed) at 64 nodes, field for field."""
    from wittgenstein_tpu.core import builders as jbuilders
    names = list(jbuilders._registry())
    assert names == list(builders._registry()) and len(names) == 54
    for name in names:
        jb, tb = jbuilders.get_by_name(name), builders.get_by_name(name)
        assert tb == builders.NodeBuilder(**vars(jb)), name
        want = jb.build(3, 64)
        got = tb.build(torch.tensor(3, dtype=torch.int32), 64, "cpu")
        for k in FIELDS:
            assert np.array_equal(np.asarray(getattr(want, k)),
                                  getattr(got, k).numpy()), (name, k)
    for speed in ("gaussian", "pareto"):
        want = jbuilders.NodeBuilder(speed=speed).build(5, 64)
        got = builders.NodeBuilder(speed=speed).build(
            torch.tensor(5, dtype=torch.int32), 64, "cpu")
        assert np.array_equal(np.asarray(want.speed_ratio),
                              got.speed_ratio.numpy()), speed
    with pytest.raises(ValueError, match="unknown speed"):
        builders.NodeBuilder(speed="warp")


def test_handel_with_uniform_speed_matches_jax():
    """Handel at 64 nodes with ``RANDOM_SPEED=GAUSSIAN_TOR=0.00`` (uniform
    speed: each node's pairing time scaled by its ratio), leaf for leaf
    against the JAX package after 200 ms."""
    import torch_parity as tp
    from wittgenstein_tpu.models.handel import Handel as JHandel
    from wittgenstein_tpu_torch.models.handel import Handel
    kw = dict(node_count=64, threshold=60,
              node_builder_name="RANDOM_SPEED=GAUSSIAN_TOR=0.00")
    want = tp.jax_chunk_states(JHandel(**kw), (0,), 200, 200)[0, 200]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        proto = Handel(**kw, device="cpu")
        assert len(set(proto.init(0)[0].nodes.speed_ratio.tolist())) > 32
        got, _ = tp.port_chunks(proto, proto.init(0), 200, 200)
    finally:
        torch.set_num_threads(threads)
    tp.assert_states_equal(want, got[200], "Handel, uniform speed")
