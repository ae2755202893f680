"""Experiment drivers of the port: parameter sweeps that run a batch of
seeds per point and write CSV (and, where matplotlib and PIL are
installed, PNG and GIF) outputs."""
