"""Engine core: state, latency physics, node builders, the per-ms step."""
