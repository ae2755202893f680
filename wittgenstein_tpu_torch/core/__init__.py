"""Engine core: state, latency physics, node builders, the per-ms and
superstep engines, the seed-folded engine and the multi-run harness."""
